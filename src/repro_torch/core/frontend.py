"""Restricted-Python frontend — the paper's "restricted OpenCL C" analogue.

Paper §3.3: operators are written in a source subset whose control flow is
a Static Control Part (SCoP), making termination and resource bounds
decidable at compile time; an LLVM backend lowers to Tiara instructions.
Here the source subset is restricted *Python* and the backend is
``repro_torch.core.program.OperatorBuilder``; the output goes through the same
registration-time verifier as hand-written programs.

Supported subset (anything else is a compile error):

  * integer parameters and integer local variables;
  * arithmetic / logical / shift binary operators, integer constants;
  * ``for i in range(CONST)``            — static trip count
  * ``for i in bounded(expr, CAP)``      — dynamic count, static cap CAP
  * ``if <cmp>: ... [else: ...]``        — forward control flow only
  * ``break``                            — exits the innermost loop
  * ``return expr`` / ``return fail(expr)``
  * intrinsics: ``load(region, off, dev=?)``, ``store(region, off, val,
    dev=?)``, ``memcpy(dst_region, dst_off, src_region, src_off, n,
    dst_dev=?, src_dev=?, is_async=?)`` (n static, or ``(expr, CAP)``),
    ``cas(region, off, cmp, new, dev=?)``, ``caa(region, off, cmp, add,
    dev=?)``, ``wait(thr)``, ``err()``.

Example::

    def walk(start, depth):
        cur = start
        for _ in bounded(depth, 16):
            cur = load("graph", cur + 1)
        return load("graph", cur)

    program = compile_operator(walk, regions=rt)
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable, Dict, List, Optional, Union

from repro_torch.core.isa import Alu, DEV_LOCAL
from repro_torch.core.memory import RegionTable
from repro_torch.core.program import Label, OperatorBuilder, Reg, TiaraProgram


class TiaraCompileError(Exception):
    def __init__(self, msg: str, node: Optional[ast.AST] = None):
        if node is not None and hasattr(node, "lineno"):
            msg = f"line {node.lineno}: {msg}"
        super().__init__(msg)


_BINOPS = {
    ast.Add: Alu.ADD, ast.Sub: Alu.SUB, ast.Mult: Alu.MUL,
    ast.BitAnd: Alu.AND, ast.BitOr: Alu.OR, ast.BitXor: Alu.XOR,
    ast.LShift: Alu.SHL, ast.RShift: Alu.SHR,
}

_CMPS = {ast.Eq: Alu.EQ, ast.NotEq: Alu.NE, ast.Lt: Alu.LT, ast.GtE: Alu.GE}
# negation for jump-over-body lowering
_NEG = {Alu.EQ: Alu.NE, Alu.NE: Alu.EQ, Alu.LT: Alu.GE, Alu.GE: Alu.LT}


class _Compiler:
    def __init__(self, name: str, arg_names: List[str],
                 regions: Optional[RegionTable], consts: Dict[str, int]):
        self.b = OperatorBuilder(name, n_params=len(arg_names),
                                 regions=regions)
        self.vars: Dict[str, Reg] = {
            a: self.b.param(i) for i, a in enumerate(arg_names)}
        self.consts = consts
        self._free_temps: List[Reg] = []
        self._break_labels: List[Label] = []

    # -- register management ----------------------------------------------

    def _temp(self) -> Reg:
        return self._free_temps.pop() if self._free_temps else self.b.reg()

    def _release(self, r: Reg) -> None:
        if r.idx >= self.b.n_params and r not in self.vars.values() \
                and r.idx < 15:
            self._free_temps.append(r)

    def _var(self, name: str, node: ast.AST) -> Reg:
        if name not in self.vars:
            self.vars[name] = self.b.reg()
        return self.vars[name]

    # -- expressions --------------------------------------------------------

    def _const_value(self, node: ast.AST) -> Optional[int]:
        """Fold to a Python int if statically known."""
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return int(node.value)
        if isinstance(node, ast.Name) and node.id in self.consts:
            return int(self.consts[node.id])
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            v = self._const_value(node.operand)
            return -v if v is not None else None
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            lv, rv = self._const_value(node.left), self._const_value(node.right)
            if lv is not None and rv is not None:
                op = _BINOPS[type(node.op)]
                return {
                    Alu.ADD: lv + rv, Alu.SUB: lv - rv, Alu.MUL: lv * rv,
                    Alu.AND: lv & rv, Alu.OR: lv | rv, Alu.XOR: lv ^ rv,
                    Alu.SHL: lv << rv, Alu.SHR: (lv % (1 << 64)) >> rv,
                }[op]
        return None

    def expr(self, node: ast.AST, out: Optional[Reg] = None) -> Reg:
        """Compile ``node``; result lands in ``out`` (or a temp)."""
        cv = self._const_value(node)
        if cv is not None:
            dst = out or self._temp()
            return self.b.movi(dst, cv)
        if isinstance(node, ast.Name):
            if node.id not in self.vars:
                raise TiaraCompileError(f"unknown variable {node.id!r}", node)
            src = self.vars[node.id]
            if out is not None and out != src:
                return self.b.mov(out, src)
            return src
        if isinstance(node, ast.BinOp):
            if type(node.op) not in _BINOPS:
                raise TiaraCompileError(
                    f"operator {type(node.op).__name__} not in the subset", node)
            alu = _BINOPS[type(node.op)]
            a = self.expr(node.left)
            rv = self._const_value(node.right)
            dst = out or self._temp()
            if rv is not None:
                self.b.alu(dst, a, alu, rv)
            else:
                breg = self.expr(node.right)
                self.b.alu(dst, a, alu, breg)
                if breg != dst:
                    self._release(breg)
            if a != dst:
                self._release(a)
            return dst
        if isinstance(node, ast.Call):
            return self._call(node, out)
        raise TiaraCompileError(
            f"expression {ast.dump(node)[:60]} not in the subset", node)

    # -- intrinsic calls -----------------------------------------------------

    def _region_arg(self, node: ast.AST) -> str:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        raise TiaraCompileError("region must be a string literal", node)

    def _dev_kw(self, kws, key: str):
        for kw in kws:
            if kw.arg == key:
                cv = self._const_value(kw.value)
                if cv is not None:
                    return cv
                return self.expr(kw.value)
        return DEV_LOCAL

    def _call(self, node: ast.Call, out: Optional[Reg]) -> Reg:
        if not isinstance(node.func, ast.Name):
            raise TiaraCompileError("only intrinsic calls allowed", node)
        fn = node.func.id
        if fn == "load":
            region = self._region_arg(node.args[0])
            off = self.expr(node.args[1])
            dev = self._dev_kw(node.keywords, "dev")
            dst = out or self._temp()
            self.b.load(dst, region, off, dev=dev)
            if off != dst:
                self._release(off)
            return dst
        if fn in ("cas", "caa"):
            region = self._region_arg(node.args[0])
            off = self.expr(node.args[1])
            cmp_ = self.expr(node.args[2])
            swp = self.expr(node.args[3])
            dev = self._dev_kw(node.keywords, "dev")
            dst = out or self._temp()
            m = self.b.cas if fn == "cas" else self.b.caa
            m(dst, region, off, cmp_, swp, dev=dev)
            for r in (off, cmp_, swp):
                if r != dst:
                    self._release(r)
            return dst
        if fn == "err":
            return self.b.err
        raise TiaraCompileError(f"unknown intrinsic {fn!r} in expression", node)

    def _stmt_call(self, node: ast.Call) -> None:
        fn = node.func.id if isinstance(node.func, ast.Name) else None
        if fn == "store":
            region = self._region_arg(node.args[0])
            off = self.expr(node.args[1])
            val = self.expr(node.args[2])
            dev = self._dev_kw(node.keywords, "dev")
            self.b.store(val, region, off, dev=dev)
            self._release(off)
            self._release(val)
            return
        if fn == "memcpy":
            dreg = self._region_arg(node.args[0])
            doff = self.expr(node.args[1])
            sreg = self._region_arg(node.args[2])
            soff = self.expr(node.args[3])
            nnode = node.args[4]
            if isinstance(nnode, ast.Tuple):           # (expr, CAP)
                nreg = self.expr(nnode.elts[0])
                cap = self._const_value(nnode.elts[1])
                if cap is None:
                    raise TiaraCompileError("memcpy cap must be static", node)
                n: Union[int, tuple] = (nreg, cap)
            else:
                nv = self._const_value(nnode)
                if nv is None:
                    raise TiaraCompileError(
                        "memcpy length must be static or (expr, CAP)", node)
                n = nv
            ddev = self._dev_kw(node.keywords, "dst_dev")
            sdev = self._dev_kw(node.keywords, "src_dev")
            is_async = False
            for kw in node.keywords:
                if kw.arg == "is_async":
                    if not isinstance(kw.value, ast.Constant):
                        raise TiaraCompileError("is_async must be literal", node)
                    is_async = bool(kw.value.value)
            self.b.memcpy(dst_region=dreg, dst_off=doff, src_region=sreg,
                          src_off=soff, n_words=n, dst_dev=ddev,
                          src_dev=sdev, is_async=is_async)
            self._release(doff)
            self._release(soff)
            return
        if fn == "wait":
            tv = self._const_value(node.args[0])
            if tv is not None:
                self.b.wait(tv)
            else:
                self.b.wait(self.expr(node.args[0]))
            return
        # expression-position intrinsics used as statements (result dropped)
        r = self._call(node, None)
        self._release(r)

    # -- statements -----------------------------------------------------------

    def _compare(self, test: ast.AST, target: Label, *, negate: bool) -> None:
        """Emit a conditional jump to ``target`` on (negated) ``test``."""
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
            raise TiaraCompileError("test must be a single comparison", test)
        op_node, rhs_node = test.ops[0], test.comparators[0]
        lhs_node = test.left
        # normalize > and <= by swapping operands
        if isinstance(op_node, ast.Gt):
            op_node, lhs_node, rhs_node = ast.Lt(), rhs_node, lhs_node
        elif isinstance(op_node, ast.LtE):
            op_node, lhs_node, rhs_node = ast.GtE(), rhs_node, lhs_node
        if type(op_node) not in _CMPS:
            raise TiaraCompileError("comparison not in the subset", test)
        cond = _CMPS[type(op_node)]
        if negate:
            cond = _NEG[cond]
        lhs = self.expr(lhs_node)
        rv = self._const_value(rhs_node)
        if rv is not None:
            self.b.jump(target, lhs, cond, rv)
        else:
            rhs = self.expr(rhs_node)
            self.b.jump(target, lhs, cond, rhs)
            self._release(rhs)
        self._release(lhs)

    def stmt(self, node: ast.stmt) -> None:
        if isinstance(node, ast.Assign):
            if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name):
                raise TiaraCompileError("only simple assignment", node)
            dst = self._var(node.targets[0].id, node)
            self.expr(node.value, out=dst)
            return
        if isinstance(node, ast.AugAssign):
            if not isinstance(node.target, ast.Name):
                raise TiaraCompileError("only simple targets", node)
            dst = self._var(node.target.id, node)
            if type(node.op) not in _BINOPS:
                raise TiaraCompileError("augmented op not in subset", node)
            alu = _BINOPS[type(node.op)]
            rv = self._const_value(node.value)
            if rv is not None:
                self.b.alu(dst, dst, alu, rv)
            else:
                r = self.expr(node.value)
                self.b.alu(dst, dst, alu, r)
                self._release(r)
            return
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            self._stmt_call(node.value)
            return
        if isinstance(node, ast.If):
            else_lbl = self.b.mklabel("else")
            end_lbl = self.b.mklabel("endif") if node.orelse else else_lbl
            self._compare(node.test, else_lbl, negate=True)
            for s in node.body:
                self.stmt(s)
            if node.orelse:
                self.b.jump(end_lbl)
                self.b.bind(else_lbl)
                for s in node.orelse:
                    self.stmt(s)
                self.b.bind(end_lbl)
            else:
                self.b.bind(else_lbl)
            return
        if isinstance(node, ast.For):
            self._for(node)
            return
        if isinstance(node, ast.Break):
            if not self._break_labels:
                raise TiaraCompileError("break outside loop", node)
            self.b.jump(self._break_labels[-1])
            return
        if isinstance(node, ast.Return):
            self._return(node)
            return
        if isinstance(node, ast.Pass):
            return
        raise TiaraCompileError(
            f"statement {type(node).__name__} not in the subset", node)

    def _for(self, node: ast.For) -> None:
        if not (isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id in ("range", "bounded")):
            raise TiaraCompileError(
                "loops must be `for i in range(CONST)` or "
                "`for i in bounded(expr, CAP)`", node)
        if node.orelse:
            raise TiaraCompileError("for-else not supported", node)
        kind = node.iter.func.id
        if kind == "range":
            if len(node.iter.args) != 1:
                raise TiaraCompileError("range() takes one static arg", node)
            m = self._const_value(node.iter.args[0])
            if m is None:
                raise TiaraCompileError(
                    "range() bound must be static; use bounded(expr, CAP)",
                    node)
            loop_arg: Union[int, tuple] = m
        else:
            cnt = self.expr(node.iter.args[0])
            cap = self._const_value(node.iter.args[1])
            if cap is None:
                raise TiaraCompileError("bounded() cap must be static", node)
            loop_arg = (cnt, cap)
        idx_name = node.target.id if isinstance(node.target, ast.Name) else "_"
        idx: Optional[Reg] = None
        if idx_name != "_":
            idx = self._var(idx_name, node)
            self.b.movi(idx, 0)
        brk = self.b.mklabel("break")
        self._break_labels.append(brk)
        with self.b.loop(loop_arg):
            for s in node.body:
                self.stmt(s)
            if idx is not None:
                self.b.alu(idx, idx, Alu.ADD, 1)
            # If an if-join label binds at the body end, a jump to it would
            # land at end+1 and read as a *break* (frame pop).  Pad with a
            # NOP so intra-iteration joins stay inside the body and fall
            # through to the loop-iterate check.
            if any(l.pc == len(self.b._instrs) for l in self.b._labels):
                self.b.nop()
        self._break_labels.pop()
        self.b.bind(brk)
        if kind == "bounded" and isinstance(loop_arg, tuple):
            self._release(loop_arg[0])

    def _return(self, node: ast.Return) -> None:
        status = 0
        value = node.value
        if (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
                and value.func.id == "fail"):
            status = 1
            value = value.args[0] if value.args else None
        if value is None:
            self.b.ret(None, status=status)
        else:
            r = self.expr(value)
            self.b.ret(r, status=status)
            self._release(r)


def compile_source(src: str, *, regions: Optional[RegionTable] = None,
                   consts: Optional[Dict[str, int]] = None,
                   name: Optional[str] = None) -> TiaraProgram:
    """Compile restricted-Python source text into a TiaraProgram."""
    return _compile_tree(ast.parse(textwrap.dedent(src)), regions=regions,
                         consts=consts, name=name)


def compile_operator(fn: Callable, *, regions: Optional[RegionTable] = None,
                     consts: Optional[Dict[str, int]] = None,
                     name: Optional[str] = None) -> TiaraProgram:
    """Compile a restricted-Python function into a TiaraProgram."""
    src = textwrap.dedent(inspect.getsource(fn))
    closure_consts = dict(consts or {})
    try:
        cv = inspect.getclosurevars(fn)
        for k, v in {**cv.nonlocals, **cv.globals}.items():
            if isinstance(v, int) and not isinstance(v, bool):
                closure_consts.setdefault(k, v)
    except TypeError:
        pass
    return _compile_tree(ast.parse(src), regions=regions,
                         consts=closure_consts, name=name)


def _compile_tree(tree: ast.Module, *, regions, consts, name) -> TiaraProgram:
    fdef = tree.body[0]
    if not isinstance(fdef, ast.FunctionDef):
        raise TiaraCompileError("expected a function definition")
    args = [a.arg for a in fdef.args.args]
    if len(args) > 8:
        raise TiaraCompileError("operators take at most 8 parameters")
    c = _Compiler(name or fdef.name, args, regions, dict(consts or {}))
    for s in fdef.body:
        # skip the docstring
        if isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant) \
                and isinstance(s.value.value, str):
            continue
        c.stmt(s)
    # ensure a trailing Ret for straight-line fallthrough
    from repro_torch.core.isa import Op
    if c.b._instrs and c.b._instrs[-1].op != Op.RET:
        c.b.ret(None, status=0)
    return c.b.build()

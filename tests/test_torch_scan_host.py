"""The recurrent scans' kernel sources on the CPU, and their route.

``selective_scan/csrc/selective_scan.cuh`` and ``wkv6/csrc/wkv6.cuh`` hold
the per-thread arithmetic and the tile staging of the two scan kernels;
``tests/selective_scan_host.cpp`` and ``tests/wkv6_host.cpp`` walk them as
the kernels do (a block's channels or columns over tiles of steps), built
with g++ here.  The host-built kernels stand in for the CUDA kernel entry
(``ops.selective_scan_kernel``, ``ops.wkv6_kernel``) behind ``impl="cuda"``,
and the port's ``mamba_forward`` and ``rwkv_time_mix`` then run against
the JAX package's (``repro.models.mamba`` / ``repro.models.rwkv``) on
numpy-seeded inputs: no cache, a cache, ragged lengths with a length-0
row, one decode step and S = 512 (the reference's chunked scan).  Each
scan call is also held against the plain version, and the kernels'
sources alone at Jamba's 16 states, RWKV-6's 64-wide heads, strided B
and C, and tiles and blocks cut mid-way.

Tolerance: 1e-5 absolute and relative (``FN_TOL``, as in
``tests/test_torch_recurrent.py``): the kernels run the plain version's
arithmetic per step, and only the order of y's sums and the fusing of
multiply-adds differ; a state read after its update or a lost mask is
O(0.1) or more.

The route: with no gradient, ``impl="cuda"`` reaches the kernel entry
once with the plain version's arguments; on a card tensor under
gradients both ``"cuda"`` and ``"auto"`` raise before any launch (the
kernels have no backward yet); on CPU and ``meta`` tensors ``"auto"``
runs the plain version, under gradients in its autograd-safe form.
"""

import ctypes
import dataclasses
import functools
import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro.models import rwkv as jrwkv
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.selective_scan import kernel as ssk
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.kernels.selective_scan import selective_scan_plain
from repro_torch.kernels.wkv6 import kernel as wkk
from repro_torch.kernels.wkv6 import ops as wk_ops
from repro_torch.kernels.wkv6 import wkv6_plain
from repro_torch.models import mamba as tmamba
from repro_torch.models import rwkv as trwkv

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = os.path.join(HERE, "..", "src", "repro_torch", "kernels")
FN_TOL = 1e-5

D = 32
MSPEC = tmamba.MambaSpec(d_state=8, d_conv=4, expand=2, dt_rank=4)
RSPEC = trwkv.RWKVSpec(head_size=8, decay_lora=8)
# (batch, seq, cache given, lengths), tests/test_torch_recurrent.py's
CASES = {
    "no_cache": (2, 24, False, None),
    "cache": (2, 24, True, None),
    "ragged": (3, 24, True, (24, 7, 2)),
    "ragged_no_cache": (3, 24, False, (24, 7, 0)),
    "decode": (3, 1, True, None),
    "chunked_512": (2, 512, True, (512, 300)),
}
# the kernels' block and tile shapes: the card's, and ones that cut
# channels, columns and steps mid-way
SS_SHAPES = ({"threads": 128, "tile": 64}, {"threads": 5, "tile": 7})
WKV_TILES = (16, 3)


def _build(tmp_path_factory, name):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    out = tmp_path_factory.mktemp(f"{name}_host") / "lib.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{os.path.join(KERNELS, name, 'csrc')}", "-o",
                    str(out), os.path.join(HERE, f"{name}_host.cpp")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    ss = _build(tmp_path_factory, "selective_scan")
    ss.selective_scan_host_run.argtypes = [ctypes.c_void_p] \
        + [ctypes.c_int64] * 3
    ss.selective_scan_host_run.restype = ctypes.c_int
    wk = _build(tmp_path_factory, "wkv6")
    wk.wkv6_host_run.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 2
    wk.wkv6_host_run.restype = ctypes.c_int
    return ss, wk


def _pack(names, values):
    ops = dict(zip(names, values))
    return (ctypes.c_int64 * len(names))(*(ops[k] for k in names))


def host_selective_scan(lib, h, dt, x, bm, cm, a_mat, valid=None, *,
                        threads=128, tile=64):
    """The kernel's source on CPU tensors, with the CUDA entry's
    arguments; returns (the last state, y)."""
    h, dt, x, a_mat = (t.contiguous() for t in (h, dt, x, a_mat))
    b, s, d = dt.shape
    n = a_mat.shape[1]
    y = torch.empty((b, s, d))
    h_out = torch.empty_like(h)
    valid = None if valid is None else valid.contiguous()
    ops = _pack(ssk.OPERANDS, (
        h.data_ptr(), dt.data_ptr(), x.data_ptr(), bm.data_ptr(),
        cm.data_ptr(), a_mat.data_ptr(),
        0 if valid is None else valid.data_ptr(), h_out.data_ptr(),
        y.data_ptr(), b, s, d, n, bm.stride(0), bm.stride(1), cm.stride(0),
        cm.stride(1)))
    assert lib.selective_scan_host_run(ops, len(ssk.OPERANDS), threads,
                                       tile) == 0
    return h_out, y


def host_wkv6(lib, state, rh, kh, vh, wh, uh, valid=None, *, tile=16):
    """The kernel's source on CPU tensors, with the CUDA entry's
    arguments; returns (the last state, y)."""
    state, rh, kh, vh, wh, uh = (t.contiguous() for t in
                                 (state, rh, kh, vh, wh, uh))
    b, s, nh, hs = rh.shape
    y = torch.empty((b, s, nh, hs))
    s_out = torch.empty_like(state)
    valid = None if valid is None else valid.contiguous()
    ops = _pack(wkk.OPERANDS, (
        state.data_ptr(), rh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
        wh.data_ptr(), uh.data_ptr(),
        0 if valid is None else valid.data_ptr(), s_out.data_ptr(),
        y.data_ptr(), b, s, nh, hs))
    assert lib.wkv6_host_run(ops, len(wkk.OPERANDS), tile) == 0
    return s_out, y


def _close(got, want, tol=FN_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _draw(rng, defs):
    """Numpy weights of a port def tree at the reference init's scales,
    the constant-initialised leaves drawn too (every term exercised)."""
    const = {"conv_b", "dt_bias", "A_log", "D_skip", "mu", "w_base",
             "u_bonus"}

    def leaf(name, pd):
        if name in const:
            return (rng.standard_normal(pd.shape) * 0.5).astype(np.float32)
        fan = pd.fan_in if pd.fan_in is not None else (
            pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1])
        return (rng.standard_normal(pd.shape) * fan ** -0.5) \
            .astype(np.float32)
    return {k: leaf(k, v) for k, v in defs.items()}


def _through_host(monkeypatch, mod, ops_mod, entry, scan_name, runner):
    """``mod._scan`` through ``ops_mod``'s ``impl="cuda"`` route with the
    kernel entry ``entry`` replaced by the host-built kernel ``runner``;
    each call is also held against the plain version.  Returns the list
    of calls made."""
    calls = []
    plain = {"selective_scan": selective_scan_plain, "wkv6": wkv6_plain}

    def kernel(*args):
        out = runner(*args)
        for g, w in zip(out, plain[scan_name](*args)):
            _close(g, w)
        calls.append(args)
        return out
    monkeypatch.setattr(ops_mod, entry, kernel)
    monkeypatch.setattr(mod, "_scan", functools.partial(
        getattr(ops_mod, scan_name), impl="cuda"))
    return calls


@pytest.mark.parametrize("name", sorted(CASES))
def test_mamba_kernel_source_matches_reference(host_libs, monkeypatch,
                                               name):
    """``mamba_forward`` with its scan on the host-built kernel (the card's
    block and tile shapes) against the JAX package's: the output and the
    carried state and conv window."""
    b, s, with_cache, lengths = CASES[name]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    w = _draw(rng, tmamba.mamba_defs(D, MSPEC))
    d_inner, _ = MSPEC.dims(D)
    cache = None
    if with_cache:
        cache = (rng.standard_normal((b, d_inner, MSPEC.d_state))
                 .astype(np.float32),
                 rng.standard_normal((b, MSPEC.d_conv - 1, d_inner))
                 .astype(np.float32))
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    jout, jc = jmamba.mamba_forward(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
        jmamba.MambaSpec(**dataclasses.asdict(MSPEC)),
        None if cache is None else jmamba.MambaCache(*map(jnp.asarray,
                                                          cache)),
        lengths=None if ln is None else jnp.asarray(ln))
    calls = _through_host(monkeypatch, tmamba, ss_ops,
                          "selective_scan_kernel", "selective_scan",
                          functools.partial(host_selective_scan,
                                            host_libs[0]))
    with torch.no_grad():
        tout, tc = tmamba.mamba_forward(
            params_from_numpy(w, device="cpu"), torch.from_numpy(x), MSPEC,
            None if cache is None else tmamba.MambaCache(
                *map(torch.from_numpy, cache)),
            lengths=None if ln is None else torch.from_numpy(ln))
    assert len(calls) == 1
    _close(tout, jout)
    if cache is not None:
        _close(tc.h, jc.h)
        _close(tc.conv, jc.conv)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rwkv_kernel_source_matches_reference(host_libs, monkeypatch, name):
    """``rwkv_time_mix`` with its scan on the host-built kernel against the
    JAX package's: the output, the carried state and the last input."""
    b, s, with_cache, lengths = CASES[name]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    w = _draw(rng, trwkv.rwkv_time_defs(D, RSPEC))
    nh = D // RSPEC.head_size
    cache = None
    if with_cache:
        cache = (rng.standard_normal((b, nh, RSPEC.head_size,
                                      RSPEC.head_size)).astype(np.float32),
                 rng.standard_normal((b, D)).astype(np.float32),
                 rng.standard_normal((b, D)).astype(np.float32))
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    jout, (js, jx) = jrwkv.rwkv_time_mix(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
        jrwkv.RWKVSpec(**dataclasses.asdict(RSPEC)),
        None if cache is None else jrwkv.RWKVCache(*map(jnp.asarray,
                                                        cache)),
        lengths=None if ln is None else jnp.asarray(ln))
    calls = _through_host(monkeypatch, trwkv, wk_ops, "wkv6_kernel", "wkv6",
                          functools.partial(host_wkv6, host_libs[1]))
    with torch.no_grad():
        tout, (ts, tx) = trwkv.rwkv_time_mix(
            params_from_numpy(w, device="cpu"), torch.from_numpy(x), RSPEC,
            None if cache is None else trwkv.RWKVCache(
                *map(torch.from_numpy, cache)),
            lengths=None if ln is None else torch.from_numpy(ln))
    assert len(calls) == 1
    _close(tout, jout)
    _close(ts, js)
    _close(tx, jx)


def _ss_inputs(rng, b, s, d, n, lengths):
    """Scan inputs at ``n`` states with ``bm`` and ``cm`` strided views of
    one projection, as ``mamba._ssm_inputs`` leaves them in f32."""
    def t(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape)
                                .astype(np.float32))
    xdb = t(b, s, 3 + 2 * n)
    valid = None if lengths is None else \
        torch.arange(s)[None] < torch.tensor(lengths)[:, None]
    return (t(b, d, n), t(b, s, d, lo=0.0, hi=2.0), t(b, s, d),
            xdb[..., 3:3 + n], xdb[..., 3 + n:], -t(d, n, lo=0.1, hi=3.0),
            valid)


@pytest.mark.parametrize("n", [16, 3, 32])
@pytest.mark.parametrize("s,lengths", [(1, None), (70, (70, 0, 33)),
                                       (130, None)])
def test_selective_scan_source_matches_plain(host_libs, n, s, lengths):
    """The kernel's source alone at Jamba's 16 states (and 3, padded, and
    32, the most it takes), strided B and C, a length-0 row, one step,
    channels and steps cut mid-block and mid-tile."""
    rng = np.random.default_rng(n * 1000 + s)
    args = _ss_inputs(rng, 3, s, 37, n, lengths)
    assert not args[3].is_contiguous()
    want = selective_scan_plain(*args)
    for shape in SS_SHAPES:
        got = host_selective_scan(host_libs[0], *args, **shape)
        for g, w in zip(got, want):
            _close(g, w)


def _wkv_inputs(rng, b, s, nh, hs, lengths):
    def t(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape)
                                .astype(np.float32))
    valid = None if lengths is None else \
        torch.arange(s)[None] < torch.tensor(lengths)[:, None]
    return (t(b, nh, hs, hs), t(b, s, nh, hs), t(b, s, nh, hs),
            t(b, s, nh, hs), t(b, s, nh, hs, lo=0.3, hi=0.999), t(nh, hs),
            valid)


@pytest.mark.parametrize("hs", [64, 8, 40])
@pytest.mark.parametrize("s,lengths", [(1, None), (37, (37, 0, 20)),
                                       (50, None)])
def test_wkv6_source_matches_plain(host_libs, hs, s, lengths):
    """The kernel's source alone at RWKV-6's 64-wide heads (and 8 and 40,
    padded), a length-0 row, one step, tiles cut mid-way."""
    rng = np.random.default_rng(hs * 1000 + s)
    args = _wkv_inputs(rng, 3, s, 2, hs, lengths)
    want = wkv6_plain(*args)
    for tile in WKV_TILES:
        got = host_wkv6(host_libs[1], *args, tile=tile)
        for g, w in zip(got, want):
            _close(g, w)


def test_padded_steps_keep_the_state_and_read_the_bonus(host_libs):
    """A padded step leaves both states alone, while its y reads the state
    (Mamba) or the state plus its own bonus u k v (RWKV-6), as the
    reference's: row 1 below has no valid step."""
    rng = np.random.default_rng(21)
    ss = _ss_inputs(rng, 2, 9, 5, 4, (9, 0))
    h, y = host_selective_scan(host_libs[0], *ss)
    assert torch.equal(h[1], ss[0][1])
    assert torch.allclose(y[1], torch.einsum("dn,sn->sd", ss[0][1],
                                             ss[4][1]), atol=FN_TOL)
    wk = _wkv_inputs(rng, 2, 9, 2, 8, (9, 0))
    st, y = host_wkv6(host_libs[1], *wk)
    assert torch.equal(st[1], wk[0][1])
    s0, r, k, v, _, u, _ = wk
    bonus = torch.einsum("shi,hi,shi,shj->shj", r[1], u, k[1], v[1])
    want = torch.einsum("shi,hij->shj", r[1], s0[1]) + bonus
    assert torch.allclose(y[1], want, atol=FN_TOL)


# -- the route ---------------------------------------------------------------

ROUTES = {
    "selective_scan": (ss_ops, "selective_scan", "selective_scan_kernel",
                       selective_scan_plain,
                       lambda rng: _ss_inputs(rng, 2, 9, 6, 4, (9, 4))),
    "wkv6": (wk_ops, "wkv6", "wkv6_kernel", wkv6_plain,
             lambda rng: _wkv_inputs(rng, 2, 9, 2, 4, (9, 4))),
}


def _recording_entry(monkeypatch, ops_mod, entry, plain):
    calls = []

    def kernel(*args):
        calls.append(args)
        return plain(*args)
    monkeypatch.setattr(ops_mod, entry, kernel)
    return calls


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_cuda_route_reaches_the_kernel_entry_once(monkeypatch, name):
    """No gradient, ``impl="cuda"``: one call of the kernel entry, with the
    arguments the plain version takes, and its result returned."""
    ops_mod, fn, entry, plain, make = ROUTES[name]
    calls = _recording_entry(monkeypatch, ops_mod, entry, plain)
    args = make(np.random.default_rng(3))
    with torch.no_grad():
        got = getattr(ops_mod, fn)(*args, impl="cuda")
    assert len(calls) == 1
    for a, c in zip(args, calls[0]):
        assert torch.equal(a, c)
    for g, w in zip(got, plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_cuda_route_under_gradients_raises(monkeypatch, name):
    """The kernels have no backward: ``impl="cuda"`` where autograd needs
    the graph raises before anything reaches the kernel entry."""
    ops_mod, fn, entry, plain, make = ROUTES[name]
    calls = _recording_entry(monkeypatch, ops_mod, entry, plain)
    args = list(make(np.random.default_rng(4)))
    args[1] = args[1].requires_grad_(True)
    with pytest.raises(ValueError, match="no backward kernel"):
        getattr(ops_mod, fn)(*args, impl="cuda")
    assert calls == []


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_auto_route_takes_the_plain_version(monkeypatch, name):
    """``impl="auto"`` on CPU tensors runs the plain version, never the
    kernel entry, and under gradients its autograd-safe form, through
    which the gradient flows; on a card tensor (the route forced to
    "cuda" here) it raises under gradients before anything launches, as
    ``"cuda"`` does, and with no gradient reaches the kernel entry."""
    ops_mod, fn, entry, plain, make = ROUTES[name]
    calls = _recording_entry(monkeypatch, ops_mod, entry, plain)
    args = make(np.random.default_rng(5))
    for g, w in zip(getattr(ops_mod, fn)(*args), plain(*args)):
        assert torch.equal(g, w)
    leaves = [a.clone().requires_grad_(True) if a.is_floating_point()
              else a for a in args]
    got = getattr(ops_mod, fn)(*leaves)
    assert calls == [] and got[1].requires_grad
    grads = torch.autograd.grad(sum(g.sum() for g in got), leaves[1])
    assert torch.isfinite(grads[0]).all()
    monkeypatch.setattr(ops_mod, "resolve_impl", lambda impl, x: "cuda")
    with pytest.raises(ValueError, match="no backward kernel"):
        getattr(ops_mod, fn)(*leaves)
    assert calls == []
    with torch.no_grad():
        getattr(ops_mod, fn)(*args)
    assert len(calls) == 1


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_meta_tensors_run_the_plain_version(name):
    """The dry-run's ``meta`` tensors take the plain version: shapes out,
    nothing computed or launched."""
    ops_mod, fn, _, plain, make = ROUTES[name]
    args = [None if a is None else a.to("meta")
            for a in make(np.random.default_rng(6))]
    got = getattr(ops_mod, fn)(*args)
    want = plain(*make(np.random.default_rng(6)))
    assert all(g.device.type == "meta" and g.shape == w.shape
               for g, w in zip(got, want))


def test_constants_match_the_wrappers():
    """The wrappers' operand orders and limits are the sources'."""
    for name, mod, limit in (("selective_scan", ssk,
                              f"kMaxState = {ssk.MAX_STATE};"),
                             ("wkv6", wkk, f"kMaxHead = {wkk.MAX_HEAD};")):
        src = open(os.path.join(KERNELS, name, "csrc",
                                f"{name}.cuh")).read()
        assert limit in src
        body = re.search(r"enum Operand : int64_t \{(.*?)\};", src,
                         re.S).group(1)
        names = [ln.split(",")[0].split("//")[0].strip()
                 for ln in body.splitlines()]
        names = [n for n in names if n]
        assert names[-1] == "kOpCount" and len(names) - 1 == \
            len(mod.OPERANDS)

"""Roofline terms for the port's traced steps, with the H100's constants."""

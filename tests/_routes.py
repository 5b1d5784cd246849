"""Test helper: run a block under one op route."""

import contextlib

import sputnik_tpu as st
from sputnik_tpu.ops._common import interpret_kernels


@contextlib.contextmanager
def route(name):
    """``"xla"``: the plain versions; ``"pallas"``: the Pallas-Triton
    kernels through the interpreter (the CPU stand-in for the GPU)."""
    if name == "pallas":
        with interpret_kernels():
            yield
        return
    st.set_backend(name)
    try:
        yield
    finally:
        st.set_backend("auto")

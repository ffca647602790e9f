"""Entry-point surface: entry() and dryrun_multichip().

``entry()`` is compile-checked on one device and ``dryrun_multichip(n)``
runs on a virtual mesh; these tests reproduce both and additionally verify
the decoded BYTES, determinism across invocations, and the example-args
contract (jit-compatible dtypes/shapes).
"""

import sys
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__ as graft  # noqa: E402


def test_entry_compiles_and_decodes_bit_exactly():
    fn, args = graft.entry()
    out = np.asarray(jax.jit(fn)(*args))
    block = graft.BLOCK
    assert out.shape == (4, block) and out.dtype == np.uint8
    # entry() decodes the deterministic _make_batch corpus: verify bytes.
    datas, _, _, _ = graft._make_batch(block, 4)
    for i, d in enumerate(datas):
        assert out[i].tobytes() == d, f"block {i}"


def test_entry_args_are_jit_friendly():
    fn, args = graft.entry()
    # callers jit with these args verbatim: all array-likes, no
    # python objects, static shapes
    for a in args:
        arr = np.asarray(a)
        assert arr.dtype in (np.uint8, np.int8, np.int16, np.int32), arr.dtype
    # second trace from numpy copies must produce identical results
    out1 = np.asarray(jax.jit(fn)(*args))
    out2 = np.asarray(jax.jit(fn)(*[np.array(a) for a in args]))
    assert (out1 == out2).all()


def test_dryrun_multichip_8():
    graft.dryrun_multichip(8)


def test_dryrun_multichip_2():
    graft.dryrun_multichip(2)

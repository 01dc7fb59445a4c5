"""Port parity: the field sampler's word path. csrc/rand_limbs.cu reduces
the 12 Threefry words of an element on 32-bit words (field_core.cuh's
redc384_words, shared with the deal's draw) and splits the 8 result words
into the 16 limbs of its output; the kernel runs only on the card
(chip_smoke.py holds it against the plain sampler there). Here its plain
twin (field_kernels._rand_limbs_words) is held against the plain sampler
(_rand_limbs_plain, the 16-bit REDC of the reference's sampler) and
Python ints, at counters near both ends of their 32-bit range.
Tolerance: exact equality of every limb."""

import pytest
import torch

from honeybadgermpc_tpu_torch.ops import field_kernels as fk
from honeybadgermpc_tpu_torch.ops.limbs import P

from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

KEY = (0x1234ABCD, 0x9E3779B9)
M32 = 0xFFFFFFFF


def _draw_int(e):
    """The element at counter e as a Python int: the 384-bit Threefry draw
    at counters (s, e) times 2^-144 mod p."""
    t = 0
    for s in range(6):
        w0, w1 = fk._threefry2x32(KEY[0], KEY[1], s, e)
        t |= (w0 | (w1 << 32)) << (64 * s)
    return t * pow(pow(2, 144, P), P - 2, P) % P


@pytest.mark.parametrize("e0", [0, 1 << 31, (1 << 32) - 257])
def test_word_path_is_the_plain_sampler_at_the_ends_of_the_counter(e0):
    """256 elements from counter e0 (the last ends at 2^32 - 2): the word
    path equals the 16-bit REDC of the same draws limb for limb, and
    Python ints at its first and last element; from 0 it is the plain
    sampler's output itself."""
    e = torch.arange(e0, e0 + 256, dtype=torch.int64)
    got = fk._rand_limbs_words(KEY, e)
    want = fk._threefry_redc384(KEY, torch.zeros_like(e), e)
    assert got.dtype == torch.int32 and tuple(got.shape) == (16, 256)
    assert torch.equal(got, want.to(torch.int32))
    if e0 == 0:
        assert torch.equal(got, fk._rand_limbs_plain(KEY, 256, "cpu"))
    for i in (0, 255):
        val = sum(int(got[j, i]) << (16 * j) for j in range(16))
        assert val == _draw_int(e0 + i)
    assert int(e[-1]) <= (1 << 32) - 2

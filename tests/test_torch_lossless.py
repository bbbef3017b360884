"""The port's Huffman decode (``core.lossless._huffman_unpack``) against
its symbol-by-symbol formulation, on the CPU.

``_huffman_unpack`` finds every chunk's code positions by pointer doubling
over a per-bit jump table; the stepwise form (one round of ops per code,
every chunk in lock step, the port's decode until the store's serving
made its 4,096 rounds per bucket the read path's wall, now
``kernels.lossless.huffman_decode_stepwise``, the decode kernel's own
formulation) is its oracle.  Tolerance: none.  Byte identity of whole segments with the JAX
reference is tests/test_torch_core.py's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import lossless as ll  # noqa: E402
from repro_torch.kernels.lossless import huffman_decode_stepwise  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("n_syms", [1, 5, 4095, 4096, 4097, 13000])
def test_huffman_unpack_matches_stepwise_decode(n_syms):
    """Pointer doubling gives every code of the symbol-by-symbol decode, on
    arbitrary streams and LUTs (zero-length entries included, where a chunk
    stalls) and zero-padded rows of unequal length."""
    rng = np.random.default_rng(n_syms)
    b, n_chunks = 3, -(-n_syms // ll.CHUNK)
    n_words = n_syms // 2 + 8
    words = rng.integers(0, 2 ** 32, (b, n_words), dtype=np.uint64)
    words[1, n_words // 2:] = 0                   # a shorter row
    lut_sym = rng.integers(0, 256, (b, 1 << 16)).astype(np.uint8)
    lut_len = rng.integers(0, 17, (b, 1 << 16)).astype(np.uint8)
    offs = np.sort(rng.integers(0, 32 * n_words, (b, n_chunks)), axis=1)
    offs[:, 0] = 0
    args = (torch.from_numpy(words.astype(np.int64)),
            torch.from_numpy(offs), torch.from_numpy(lut_sym),
            torch.from_numpy(lut_len), n_syms)
    got = ll._huffman_unpack(*args)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (b, n_syms)
    assert torch.equal(got, huffman_decode_stepwise(*args))

"""The port's Huffman decode (``core.lossless._huffman_unpack``) against
its symbol-by-symbol formulation, on the CPU.

``_huffman_unpack`` finds every chunk's code positions by pointer doubling
over a per-bit jump table; the stepwise form below (one round of ops per
code, every chunk in lock step, the port's decode until the store's
serving made its 4,096 rounds per bucket the read path's wall) is its
oracle.  Tolerance: none.  Byte identity of whole segments with the JAX
reference is tests/test_torch_core.py's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import lossless as ll  # noqa: E402

torch.set_num_threads(1)


def _huffman_unpack_stepwise(words, chunk_offs, lut_sym, lut_len, n_syms):
    """The symbol-by-symbol formulation of ``lossless._huffman_unpack`` (one
    round of ops per code, every chunk in lock step), kept as its oracle."""
    b = words.shape[0]
    w = words.to(torch.int64) & 0xFFFFFFFF
    pad = ll.CHUNK * ll.MAX_CODE_LEN // 32 + 2
    w = torch.cat([w, torch.zeros((b, pad), dtype=torch.int64)], dim=1)
    pair = (w[:, :-1] << 32) | w[:, 1:]
    lut = (lut_sym.to(torch.int64) & 0xFF) | (lut_len.to(torch.int64) << 8)
    p = chunk_offs.to(torch.int64) & 0xFFFFFFFF
    steps = min(ll.CHUNK, n_syms)
    out = torch.empty((b, p.shape[1], steps), dtype=torch.int64)
    for k in range(steps):
        v = torch.gather(pair, 1, p >> 5)
        e = torch.gather(lut, 1, (v >> (48 - (p & 31))) & 0xFFFF)
        out[:, :, k] = e
        p = p + (e >> 8)
    return (out.reshape(b, -1)[:, :n_syms] & 0xFF).to(torch.uint8)


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
    assert torch.equal(got, _huffman_unpack_stepwise(*args))

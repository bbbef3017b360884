"""Inputs at the edges of the lossless kernels, shared by the CPU tests
(``test_torch_lossless_kernels.py``) and the card tests
(``test_torch_cuda.py``): ``huffman_decode``'s self-synchronising walks,
``rle_expand``'s look-back tiles and ``rle_scan``'s tiles, pieces and
segments.  numpy and the port only (the card tests import no JAX); every
input is made from a seed, on the CPU.

``decode_cases()``: {name: (words int32, chunk_offs int64, lut_sym,
lut_len, n_syms)}, words cut to the stored width (``decode_segments``'
padding to a bucket's longest row) unless the case says otherwise.
``expand_cases()``: {name: (values uint8, lengths int32, n)}.
``scan_cases()``: {name: (B, S) uint8 rows}.
"""
import numpy as np
import torch

from repro_torch.core import lossless as ll

# the decode cases a chunk of which must take the serial walk
SERIAL = ("missed end", "past the words")
# the decode case whose chunks need two or more synchronisation rounds
ROUNDS = "two rounds"


def _stream(rows, stored=True):
    """Each row's codebook from its histogram, the plain pack of ``rows``
    ((B, S) uint8) and the decode tables."""
    books = [ll.build_codebook(np.bincount(r, minlength=256)) for r in rows]
    lt, ct = (torch.from_numpy(np.stack([bk[i] for bk in books]
                                        ).astype(np.int64)) for i in (0, 1))
    x = torch.from_numpy(np.ascontiguousarray(rows))
    words, total, offs = ll._huffman_pack_plain(x, lt, ct)
    if stored:
        words = words[:, :int(((total + 31) // 32 + 1).max())]
    luts = [ll._build_decode_lut(*bk) for bk in books]
    ls, ln = (torch.from_numpy(np.stack([lu[i] for lu in luts]))
              for i in (0, 1))
    return [words.contiguous(), offs.contiguous(), ls, ln, rows.shape[1]]


def _fibonacci_rows(rng, reps):
    """A row whose codebook reaches 16-bit codes: symbol i appears F(i + 1)
    times (Fibonacci weights give the deepest Huffman tree)."""
    fib = [1, 1]
    while len(fib) < 20:
        fib.append(fib[-1] + fib[-2])
    row = np.repeat(np.arange(20, dtype=np.uint8), fib)
    return np.stack([rng.permutation(np.tile(row, reps)) for _ in range(2)])


def decode_cases():
    rng = np.random.default_rng(29)
    cases = {}
    cases["one symbol"] = _stream(np.full((2, 9000), 5, np.uint8))
    deep = _fibonacci_rows(rng, 1)
    assert int(ll.build_codebook(np.bincount(deep[0], minlength=256))[0]
               .max()) == ll.MAX_CODE_LEN
    cases["16-bit codes"] = _stream(deep)
    # 255 of 256 symbols: 8-bit codes but one of 7 bits, which a walk from
    # a wrong bit meets too seldom to fall into step within its span
    near = rng.integers(0, 255, (1, 3 * ll.CHUNK + 5)).astype(np.uint8)
    cases[ROUNDS] = _stream(near)
    skew = (rng.geometric(0.3, (1, 3 * ll.CHUNK)) % 256).astype(np.uint8)
    case = _stream(skew)
    case[1] = case[1].clone()
    case[1][0, 1] += 1          # chunk 0's codes no longer end at off[1]
    cases["missed end"] = case
    case = _stream(skew)            # the last chunk's codes read zeros
    case[0] = case[0][:, :int(case[1][:, -1].max()) // 32 + 8].contiguous()
    cases["past the words"] = case
    mixed = np.concatenate([
        (rng.geometric(0.6, (1, 2 * ll.CHUNK + 77)) % 256),
        rng.integers(0, 256, (1, 2 * ll.CHUNK + 77))]).astype(np.uint8)
    cases["padded rows"] = _stream(mixed)   # a short row's zero tail
    cases["full width"] = _stream(skew, stored=False)
    return cases


def _runs(rng, r, longest):
    values = rng.integers(0, 256, (2, r)).astype(np.uint8)
    lengths = rng.integers(1, longest + 1, (2, r)).astype(np.int32)
    return values, lengths


def expand_cases():
    rng = np.random.default_rng(30)
    cases = {}
    values, lengths = _runs(rng, 9000, 6)
    total = int(lengths.sum(1).min())
    cases["short of n"] = (values, lengths, int(lengths.sum(1).max()) + 100)
    cases["past n"] = (values, lengths, total - 100)
    values, lengths = _runs(rng, 9000, 4)
    for at in (0, 1, 4095, 4096, 4097, 8191, 8192, 8998, 8999):
        lengths[:, at] = 0
    lengths[:, rng.integers(0, 9000, 500)] = 0
    cases["zero-length runs"] = (values, lengths,
                                 int(lengths.sum(1).max()))
    values, lengths = _runs(rng, 40, 30000)
    cases["long runs"] = (values, lengths, int(lengths.sum(1).min()))
    return {k: (torch.from_numpy(v), torch.from_numpy(ln), n)
            for k, (v, ln, n) in cases.items()}


def _from_runs(rng, lengths, s):
    """A row of length s: runs of the given lengths, cycled, each a
    symbol other than the one before it."""
    out = np.empty(s, np.uint8)
    at, i, sym = 0, 0, 0
    while at < s:
        n = lengths[i % len(lengths)]
        sym = (sym + 1 + int(rng.integers(0, 255))) % 256
        out[at:at + n] = sym
        at += n
        i += 1
    return out


def scan_cases():
    rng = np.random.default_rng(31)
    brk = ll.RLE_BREAK
    skew = lambda b, s: (rng.geometric(0.3, (b, s)) % 256).astype(np.uint8)
    cases = {
        "RLE_BREAK": skew(2, brk),
        "RLE_BREAK - 1": skew(2, brk - 1),
        "RLE_BREAK + 1": skew(2, brk + 1),
        "S = 1": rng.integers(0, 256, (4, 1)).astype(np.uint8),
        # every neighbour differs: a run a symbol
        "all distinct": np.tile(np.arange(70_000) % 256, (2, 1)
                                ).astype(np.uint8),
        "unaligned rows": skew(5, 4099),
    }
    # one run over three tiles, broken only at each multiple of RLE_BREAK,
    # and a last run of 50
    row = np.full(3 * brk + 100, 9, np.uint8)
    row[-50:] = 4
    cases["one run over tiles"] = row[None]
    # runs either side of a segment (16), a step (32) and a piece (512)
    edges = [15, 16, 17, 31, 32, 33, 511, 512, 513, 1, 2, 1]
    cases["segment and piece edges"] = np.stack(
        [_from_runs(rng, edges, 70_000),
         _from_runs(rng, edges[::-1], 70_000)])
    # a tile whose last symbol is a run of its own, and a run that reaches
    # the next tile
    row = np.full(2 * brk + 7, 3, np.uint8)
    row[brk - 1] = 8
    row[brk - 300:brk - 1] = 5
    cases["tile ends"] = row[None]
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in cases.items()}

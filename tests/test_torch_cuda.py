"""Card-only tests of the PyTorch port (``cuda`` marker; skip without a card).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only torch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CUDA kernels are held bit-exact against their plain torch versions, and
the whole port on the card against the port on the CPU (which the other
``tests/test_torch_*.py`` files hold against the reference).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import lossless_batch as lb  # noqa: E402
from repro_torch.core import refactor as rf  # noqa: E402
from repro_torch.core import retrieve as rt  # noqa: E402
from repro_torch.data.fields import gaussian_field  # noqa: E402
from repro_torch.kernels import bitplane as bp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_kernels_match_plain(cuda):
    rng = np.random.default_rng(1)
    for n, p, b in [(1, 1, 1), (4095, 7, 1), (4097, 23, 3), (12289, 32, 2)]:
        mags = rng.integers(0, 2 ** 32, (b, n), dtype=np.uint64
                            ).astype(np.uint32)
        x = torch.from_numpy(mags.view(np.int32)).to(cuda)
        before = bp.encode_register_block_cuda.launches
        got = ops.encode_bitplanes_batch(x, p, device=cuda)
        assert bp.encode_register_block_cuda.launches == before + 1
        assert torch.equal(got.cpu(), ref.encode(x.cpu(), p))
        for off in (0, min(4, p - 1)):
            sl = got[:, off:].contiguous()
            dec = ops.decode_bitplanes_offset_batch(sl, p, n, off,
                                                    device=cuda)
            assert torch.equal(dec.cpu(), ref.decode(sl.cpu(), p - off, n))


@pytest.mark.parametrize("design", ["locality", "shuffle"])
def test_tensor_without_kernel_raises(cuda, design):
    x = torch.arange(100, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError):
        ops.encode_bitplanes(x, 8, design, device=cuda)
    with pytest.raises(NotImplementedError):
        ops.decode_bitplanes(torch.zeros((1, 128), dtype=torch.int32,
                                         device=cuda), 8, 100, design,
                             device=cuda)
    # the plain version stays an explicit choice
    assert torch.equal(
        ops.encode_bitplanes(x, 8, design, backend="torch", device=cuda).cpu(),
        ops.encode_bitplanes(x.cpu(), 8, design, device="cpu"))


def test_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 300), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bp.encode_register_block_cuda(x, 33)
    with pytest.raises(ValueError):
        bp.encode_register_block_cuda(x, 0)
    with pytest.raises(ValueError):
        bp.encode_register_block_cuda(x[:, ::2], 8)
    with pytest.raises(TypeError):
        bp.encode_register_block_cuda(x.to(torch.int64), 8)
    with pytest.raises(ValueError):
        bp.decode_register_block_cuda(torch.zeros((1, 5, 128),
                                                  dtype=torch.int32,
                                                  device=cuda), 4, 100)
    with pytest.raises(ValueError):
        bp.decode_register_block_cuda(torch.zeros((1, 4, 100),
                                                  dtype=torch.int32,
                                                  device=cuda), 4, 100)
    with pytest.raises(ValueError):
        bp.encode_register_block_cuda(x.cpu(), 8)


@pytest.mark.parametrize("shape", [(), (0,), (1, 5, 1), (33, 47),
                                   (16, 20, 24)])
@pytest.mark.parametrize("path", [{}, {"fused": False}, {"batched": False}])
def test_card_matches_cpu(cuda, shape, path):
    rng = np.random.default_rng(7)
    x = (gaussian_field(shape, seed=3) if np.prod(shape, dtype=int) > 100
         else rng.normal(size=shape).astype(np.float32))
    blobs = {d: rf.refactored_to_bytes(rf.refactor_array(
        x, "c", device=d, **path)) for d in (cuda, "cpu")}
    assert blobs[cuda] == blobs["cpu"]
    want = rt.ProgressiveReader(rf.refactored_from_bytes(blobs["cpu"]),
                                device="cpu")
    readers = [rt.ProgressiveReader(rf.refactored_from_bytes(blobs["cpu"]),
                                    device=cuda, incremental=inc)
               for inc in (True, False)]
    for tol in (1e-2, 1e-4, 1e-6):
        b = want.retrieve(tol, relative=True)
        for reader in readers:
            a = reader.retrieve(tol, relative=True)
            assert a[1:] == b[1:]
            assert a[0].tobytes() == b[0].tobytes()


def test_host_syncs_on_the_card(cuda):
    """3 host syncs per chunk on write and at most 1 per fetch on read, as
    the reference counts them; the kernels serve both sides."""
    x = gaussian_field((40, 36, 20), seed=5)
    enc0 = bp.encode_register_block_cuda.launches
    dec0 = bp.decode_register_block_cuda.launches
    with lb.stats_scope() as st:
        r = rf.refactor_array(x, "s", device=cuda)
    assert st.host_syncs == 3
    reader = rt.ProgressiveReader(r, device=cuda)
    for tol in (1e-2, 1e-5):
        with lb.stats_scope() as st:
            reader.retrieve(tol)
        assert st.host_syncs <= 1
    assert bp.encode_register_block_cuda.launches > enc0
    assert bp.decode_register_block_cuda.launches > dec0


@pytest.mark.parametrize("path", [{}, {"fused": False}, {"batched": False}])
def test_overflowing_magnitude_raises_on_the_card(cuda, path):
    x = np.array([1023.99994, 511.99997, -1023.99994], np.float32)
    with pytest.raises(ValueError, match="2\\*\\*23"):
        rf.refactor_array(x, "o", device=cuda, **path)

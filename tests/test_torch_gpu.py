"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is false: a CUDA kernel has no CPU mode.
This file imports nothing of JAX, so it runs on a machine with a card
and PyTorch alone:

    python -m pytest tests/test_torch_gpu.py -m gpu

The kernel computes the plain version's function bit for bit (same
rounded operations, same tie order), so distances and indices must be
equal, not merely close.
"""
import numpy as np
import pytest
import torch

from loam_livox_tpu_torch.core.types import PointBatch
from loam_livox_tpu_torch.ops import knn_fused as kf
from loam_livox_tpu_torch.ops.knn import knn
from loam_livox_tpu_torch.ops.voxel import voxel_downsample

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def voxel_map(rng, m, extent, leaf, fill):
    """A voxel-sorted buffer of capacity m, its first ``fill`` share valid."""
    raw = rng.uniform(-extent, extent, (2 * m, 3)).astype(np.float32)
    b = voxel_downsample(PointBatch(torch.from_numpy(raw), torch.zeros(2 * m),
                                    torch.ones(2 * m, dtype=torch.bool)), leaf, capacity=m)
    mask = b.mask.clone()
    mask[int(fill * m):] = False
    return b.xyz.numpy(), mask.numpy()


CASES = {
    # name: (queries, capacity, extent, leaf, fill, k, radius, query_count)
    "corner_full": (512, 16384, 12.0, 0.1, 1.0, 5, 2.0 ** 0.5, None),
    "surface_prefix": (2048, 65536, 12.0, 0.4, 0.05, 5, 50.0 ** 0.5, 1500),
    "no_radius_ragged": (300, 4000, 10.0, 0.4, 0.7, 5, None, None),
    "few_refs_k8": (130, 2048, 5.0, 0.4, 0.001, 8, None, 77),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_equals_plain(cuda, name):
    nq, m, extent, leaf, fill, k, radius, count = CASES[name]
    rng = np.random.default_rng(len(name))
    ref, mask = voxel_map(rng, m, extent, leaf, fill)
    q = (ref[rng.integers(0, max(int(fill * m), 1), nq)]
         + rng.normal(0, 0.3, (nq, 3))).astype(np.float32)
    q, ref, mask = (torch.from_numpy(a).to(cuda) for a in (q, ref, mask))
    cnt = None if count is None else torch.tensor(count, device=cuda)
    before = kf.launches
    d, i = kf.knn_fused(q, ref, mask, k=k, query_count=cnt, max_radius=radius)
    torch.cuda.synchronize()
    assert kf.launches == before + 1
    dp, ip = knn(q, ref, mask, k=k, query_count=count, max_radius=radius)
    assert torch.equal(d, dp)
    assert torch.equal(i, ip)
    assert (d < 1e29).any()


def test_wrapper_rejects_bad_inputs(cuda):
    q = torch.zeros((4, 3), device=cuda)
    ref = torch.zeros((8, 3), device=cuda)
    mask = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        kf.knn_fused(q.double(), ref, mask)
    with pytest.raises(ValueError):
        kf.knn_fused(q, ref, mask, k=9)
    with pytest.raises(ValueError):
        kf.knn_fused(q.t().contiguous().t(), ref, mask)

"""Keyframe place-recognition descriptors (reference `Maps_keyframe`,
``source/cell_map_keyframe.hpp:1002-1624``), the counterpart of
``loam_livox_tpu/loop/keyframe.py``.

A keyframe is the set of cells its frames touched.  Its descriptor is a
pair of rotation-invariant 60 × 60 spherical histograms of the line and
plane directions of those cells (reference ``:35-36``):

1. `map.cell_features` classifies each cell and gives its direction;
2. the eigenvectors of the plane directions' second moment, in
   descending eigenvalue order and made right-handed, are a canonical
   rotation (reference ``generate_feature_img`` :1385-1427);
3. each direction is rotated into that frame, flipped to x ≥ 0, binned
   by (φ, θ) (reference ``feature_direction`` :1072-1090), counted, and
   blurred by a Gaussian with wrap padding (reference :1358-1370);
4. the similarity of two images is the largest normalised
   cross-correlation of one over the other wrap-padded by half its size
   (OpenCV ``matchTemplate`` CCORR_NORMED, reference :1157-1229).

The blur and the correlation are ``F.conv2d``.  The eigenvectors'
signs are up to the solver; a flipped first axis mirrors φ, which the
correlation does not undo, so two solvers can give mirrored images of
one keyframe.  The canonical rotation's 3 × 3 solve therefore runs on
the host on every device (LAPACK, as the JAX package's CPU path; its
signs may still differ from jaxlib's LAPACK call on the same matrix).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..map.cell_map import FEATURE_LINE, FEATURE_PLANE, CellMap, cell_features
from ..ops.masked import masked_quantile_l1

PHI_RESOLUTION = 60    # reference cell_map_keyframe.hpp:35
THETA_RESOLUTION = 60  # reference cell_map_keyframe.hpp:36


class KeyframeDescriptor(NamedTuple):
    img_line: torch.Tensor           # (60, 60) blurred histogram
    img_plane: torch.Tensor
    img_line_roi: torch.Tensor       # the cells within roi_range
    img_plane_roi: torch.Tensor
    ratio_nonzero_line: torch.Tensor  # nonzero share before the blur (:1140-1154)
    ratio_nonzero_plane: torch.Tensor
    center: torch.Tensor             # (3,) mean of the member cell centres
    roi_range: torch.Tensor          # 0.90-quantile centre distance (:1304-1319)
    n_cells: torch.Tensor            # member cells
    n_line: torch.Tensor
    n_plane: torch.Tensor


def _gaussian_kernel_2d(ksize: int, sigma: float, device) -> torch.Tensor:
    """OpenCV's separable Gaussian, (2k+1, 2k+1)."""
    x = torch.arange(-ksize, ksize + 1, dtype=torch.float32, device=device)
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def _wrap_pad(img: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """Torus wrap padding (reference `add_padding_to_feature_image`,
    :1321-1356: blocks copied from the opposite side)."""
    v = torch.cat([img[-py:], img, img[:py]], dim=0)
    return torch.cat([v[:, -px:], v, v[:, :px]], dim=1)


def _correlate(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid 2-D cross-correlation of one image with one kernel."""
    return F.conv2d(img[None, None], kernel[None, None])[0, 0]


def _blur(img: torch.Tensor, ksize: int = 4, sigma: float = 4.0) -> torch.Tensor:
    """Gaussian blur with wrap padding (reference :1358-1370)."""
    return _correlate(_wrap_pad(img, ksize, ksize),
                      _gaussian_kernel_2d(ksize, sigma, img.device))


def _feature_direction_bins(vecs: torch.Tensor):
    """(φ, θ) bins of each direction (reference :1072-1090): flip to
    x ≥ 0, φ = atan2(y, x) + π/2, θ = asin(z) + π/2, floor-binned over π."""
    v = torch.where((vecs[:, 0] < 0)[:, None], -vecs, vecs)
    nrm = torch.linalg.vector_norm(v, dim=-1)
    vz = torch.where(nrm[:, None] > 1e-9, v / torch.clamp(nrm, min=1e-9)[:, None],
                     torch.zeros((), device=v.device))
    phi = torch.atan2(vz[:, 1], vz[:, 0]) + torch.pi / 2
    theta = torch.asin(torch.clamp(vz[:, 2], -1.0, 1.0)) + torch.pi / 2

    def step(n):
        # a device divisor: CUDA would multiply by a host scalar's reciprocal
        return torch.full((), torch.pi / n, dtype=torch.float32, device=v.device)

    phi_idx = torch.clamp(torch.floor(phi / step(PHI_RESOLUTION)),
                          0, PHI_RESOLUTION - 1).to(torch.int64)
    theta_idx = torch.clamp(torch.floor(theta / step(THETA_RESOLUTION)),
                            0, THETA_RESOLUTION - 1).to(torch.int64)
    return phi_idx, theta_idx


def _hist_image(vecs: torch.Tensor, mask: torch.Tensor, rot: torch.Tensor):
    """Blurred (60, 60) histogram of the rotated directions and the share
    of nonzero bins before the blur (reference :1385-1427)."""
    pi_, ti_ = _feature_direction_bins(vecs @ rot)
    n_bins = PHI_RESOLUTION * THETA_RESOLUTION
    flat = torch.where(mask, pi_ * THETA_RESOLUTION + ti_, torch.full_like(pi_, n_bins))
    img = torch.zeros((n_bins + 1,), dtype=torch.float32, device=vecs.device)
    img = img.index_add_(0, flat, mask.to(torch.float32))[:n_bins]
    img = img.reshape(PHI_RESOLUTION, THETA_RESOLUTION)
    return _blur(img), (img >= 1.0).to(torch.float32).mean()


def _alignment_rotation(vecs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Canonical rotation from the plane directions' second moment
    (reference `eigen_decompose_of_featurevector` :1553-1567 and the
    reordering of `generate_feature_img` :1389-1393)."""
    w = mask.to(torch.float32)
    m = torch.einsum("n,ni,nj->ij", w, vecs, vecs)
    # the 3 × 3 solve runs on the host (LAPACK) on every device: the
    # eigenvectors' signs are the solver's choice, and cuSOLVER's may
    # differ from LAPACK's, which would mirror the card's images of a
    # keyframe against the CPU's (one read a rotation, off the frame path)
    _, vec = torch.linalg.eigh(m.cpu())    # ascending
    vec = vec.flip(-1).to(m.device)        # descending
    c2 = torch.linalg.cross(vec[:, 0], vec[:, 1], dim=-1)
    return torch.stack([vec[:, 0], vec[:, 1], c2], dim=1)


def describe_keyframe(m: CellMap, member: torch.Tensor,
                      incremental: bool = True) -> KeyframeDescriptor:
    """Descriptor of the keyframe whose member cells the (C,) mask
    ``member`` flags (reference `analyze` → `extract_feature_mapping_new`,
    :1429-1494).  ``incremental`` is
    ``common/if_update_mean_and_cov_incrementally``.  Reads the two 3 × 3
    moment matrices on the host (`_alignment_rotation`)."""
    feats = cell_features(m, incremental=incremental)
    member = member & m.valid()
    centers = m.centers()

    nc = torch.clamp(member.to(torch.float32).sum(), min=1.0)
    center = torch.where(member[:, None], centers, torch.zeros((), device=centers.device)
                         ).sum(dim=0) / nc
    d = torch.linalg.vector_norm(centers - center, dim=-1)
    # 0.90-quantile of the member distances (reference ratio 0.90, :1438)
    roi_range = masked_quantile_l1(d, member, 0.90)

    is_line = member & (feats.feature_type == FEATURE_LINE)
    is_plane = member & (feats.feature_type == FEATURE_PLANE)
    in_roi = member & (d < roi_range)

    rot = _alignment_rotation(feats.feature_dir, is_plane)
    rot_roi = _alignment_rotation(feats.feature_dir, is_plane & in_roi)
    img_line, rz_line = _hist_image(feats.feature_dir, is_line, rot)
    img_plane, rz_plane = _hist_image(feats.feature_dir, is_plane, rot)
    img_line_roi, _ = _hist_image(feats.feature_dir, is_line & in_roi, rot_roi)
    img_plane_roi, _ = _hist_image(feats.feature_dir, is_plane & in_roi, rot_roi)

    return KeyframeDescriptor(
        img_line=img_line, img_plane=img_plane,
        img_line_roi=img_line_roi, img_plane_roi=img_plane_roi,
        ratio_nonzero_line=rz_line, ratio_nonzero_plane=rz_plane,
        center=center, roi_range=roi_range,
        n_cells=member.sum(dtype=torch.int32),
        n_line=is_line.sum(dtype=torch.int32),
        n_plane=is_plane.sum(dtype=torch.int32))


def max_similarity(img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
    """Largest normalised cross-correlation of ``img_a`` slid over
    ``img_b`` wrap-padded by half the resolution (reference
    ``matchTemplate(..., CV_TM_CCORR_NORMED)`` over
    ``add_padding_to_feature_image(img_b, 30, 30)``, :1196-1199,
    1211-1229)."""
    b = _wrap_pad(img_b, PHI_RESOLUTION // 2, THETA_RESOLUTION // 2)
    num = _correlate(b, img_a)
    b2 = _correlate(b * b, torch.ones_like(img_a))
    a2 = (img_a * img_a).sum()
    return (num / torch.sqrt(torch.clamp(b2 * a2, min=1e-12))).max()

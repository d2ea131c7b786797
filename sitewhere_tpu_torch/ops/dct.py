"""On-device JPEG reconstruction — the port of ``sitewhere_tpu/ops/dct.py``.

The device half of the compressed media wire: truncated int16 zigzag DCT
coefficient planes (the host's entropy decode ships them) back to RGB
frames, and on into the classifier's patches. The layout helpers are the
reference's, copied; the decode is written over tensors with the
reference's math (dezigzag, the 8x8 IDCT ``M^T C M`` in f32, +128, the
libjpeg "fancy" triangle chroma upsample, JFIF YCbCr -> RGB with the clamp).

Kernel KJ ``dct_patches`` (``csrc/dct_patches.cu``) does all of it in one
pass and goes on to the classifier's input: the u8 wire's normalization
``(rgb / 255 - 0.5) / 0.5`` (``models/vit.py`` ``apply_dct``), patchify and
the cast to the compute dtype. ``dct_patches_plain`` is its plain version;
on CPU tensors the wrapper takes it, on CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch import kernels

# zigzag position -> natural (row-major) position inside an 8x8 block
ZIGZAG = np.array([
    0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

# static truncation-width ladder: each batch's max zigzag extent is
# bucketed up to one of these (64 = full precision)
COEF_BUCKETS = (8, 16, 32, 64)


def coef_bucket(k: int) -> int:
    """Smallest ladder width holding a zigzag extent of ``k``."""
    for b in COEF_BUCKETS:
        if k <= b:
            return b
    return 64


class FrameLayout(NamedTuple):
    """Static geometry of one coefficient batch.

    width/height: true pixel dims (crop target); y_gw/y_gh and
    c_gw/c_gh: padded MCU-aligned block grids the coefficients cover;
    sub: 1 = 4:4:4, 2 = 4:2:0; k: zigzag truncation width on the wire.
    """

    width: int
    height: int
    y_gw: int
    y_gh: int
    c_gw: int
    c_gh: int
    sub: int
    k: int

    @property
    def y_blocks(self) -> int:
        return self.y_gw * self.y_gh

    @property
    def c_blocks(self) -> int:
        return self.c_gw * self.c_gh

    def wire_bytes(self, batch: int = 1) -> int:
        """int16 payload bytes one batch ships h2d at this layout."""
        return 2 * self.k * batch * (self.y_blocks + 2 * self.c_blocks)


def layout_for(width: int, height: int, sub: int, k: int) -> FrameLayout:
    """The layout a ``width x height`` frame decodes to at subsampling
    ``sub`` (padded MCU-aligned grids)."""
    mcu = 8 * sub
    mw = (width + mcu - 1) // mcu
    mh = (height + mcu - 1) // mcu
    return FrameLayout(
        width=width, height=height,
        y_gw=mw * sub, y_gh=mh * sub, c_gw=mw, c_gh=mh,
        sub=sub, k=k,
    )


def idct_basis() -> np.ndarray:
    """Orthonormal 8-point DCT-II basis ``M`` (forward: C = M X M^T,
    inverse: X = M^T C M)."""
    m = np.zeros((8, 8), np.float64)
    for u in range(8):
        a = np.sqrt(1.0 / 8.0) if u == 0 else np.sqrt(2.0 / 8.0)
        for x in range(8):
            m[u, x] = a * np.cos((2 * x + 1) * u * np.pi / 16.0)
    return m.astype(np.float32)


def dezigzag_matrix(k: int) -> np.ndarray:
    """``[k, 64]`` one-hot scatter: zigzag-truncated wire -> natural order."""
    s = np.zeros((k, 64), np.float32)
    s[np.arange(k), ZIGZAG[:k]] = 1.0
    return s


def decode_flops_per_frame(layout: FrameLayout) -> float:
    """Analytic matmul FLOPs (2/MAC) one frame costs through the
    reference's decode: dezigzag + the two IDCT matmuls per block."""
    n_blocks = layout.y_blocks + 2 * layout.c_blocks
    dezig = 2.0 * layout.k * 64
    idct = 2.0 * 2 * 8 * 8 * 8  # two [8,8]x[8,8] matmuls
    return n_blocks * (dezig + idct)


# -- the decode over tensors -------------------------------------------------------

def idct_plane(coef_z: torch.Tensor, gh: int, gw: int, k: int) -> torch.Tensor:
    """Zigzag coefficient blocks ``i16/f32[B, gh*gw, k]`` -> pixel plane
    ``f32[B, gh*8, gw*8]`` (level-shifted to 0..255). The dezigzag is the
    reference's one-hot product written as the scatter it equals."""
    b = coef_z.shape[0]
    x = coef_z.to(torch.float32)
    nat = torch.zeros((b, gh * gw, 64), dtype=torch.float32, device=x.device)
    nat[..., torch.from_numpy(ZIGZAG[:k]).long().to(x.device)] = x
    blocks = nat.reshape(b, gh, gw, 8, 8)
    m = torch.from_numpy(idct_basis()).to(x.device)
    px = torch.einsum("ux,bgwuv,vy->bgwxy", m, blocks, m) + 128.0
    return px.permute(0, 1, 3, 2, 4).reshape(b, gh * 8, gw * 8)


def _upsample2x_1d(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Double ``axis`` with the libjpeg "fancy" triangle filter: each
    output pair is (3 cur + prev)/4, (3 cur + next)/4 with edge
    replication."""
    n = x.shape[axis]
    lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    a = 0.75 * x + 0.25 * lo
    c = 0.75 * x + 0.25 * hi
    stacked = torch.stack([a, c], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


def upsample2x(plane: torch.Tensor) -> torch.Tensor:
    """``f32[B, H, W]`` -> ``f32[B, 2H, 2W]`` triangle upsample, rows
    first."""
    return _upsample2x_1d(_upsample2x_1d(plane, 1), 2)


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """JFIF BT.601 full-range conversion; output ``f32[B, H, W, 3]``
    clamped to 0..255."""
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def decode_frames(
    y_z: torch.Tensor, cb_z: torch.Tensor, cr_z: torch.Tensor, layout: FrameLayout,
) -> torch.Tensor:
    """Truncated zigzag coefficient batch -> RGB frames ``f32[B, height,
    width, 3]`` in 0..255. ``y_z``: ``[B, y_blocks, k]``;
    ``cb_z``/``cr_z``: ``[B, c_blocks, k]``. The chroma planes are
    upsampled over their whole padded grid (edges replicated there) before
    the crop, as the reference does."""
    yp = idct_plane(y_z, layout.y_gh, layout.y_gw, layout.k)
    cbp = idct_plane(cb_z, layout.c_gh, layout.c_gw, layout.k)
    crp = idct_plane(cr_z, layout.c_gh, layout.c_gw, layout.k)
    if layout.sub == 2:
        cbp = upsample2x(cbp)
        crp = upsample2x(crp)
    h, w = layout.height, layout.width
    return ycbcr_to_rgb(yp[:, :h, :w], cbp[:, :h, :w], crp[:, :h, :w])


# -- kernel KJ: decode, normalize, patchify ---------------------------------------------

def dct_patches_plain(
    y_z, cb_z, cr_z, layout: FrameLayout, patch: int, dtype: torch.dtype,
) -> torch.Tensor:
    """Plain version of KJ: ``decode_frames``, the u8 wire's normalization
    ``(rgb / 255 - 0.5) / 0.5`` in f32, ``patchify`` and the cast ->
    ``[B, N, patch*patch*3]`` in ``dtype``."""
    from sitewhere_tpu_torch.models.vit import patchify  # models.vit imports this module

    rgb = decode_frames(y_z, cb_z, cr_z, layout)
    return patchify((rgb / 255.0 - 0.5) / 0.5, patch).to(dtype)


def _check_coeffs(y_z, cb_z, cr_z, layout: FrameLayout) -> None:
    """The coefficient planes' shapes against ``layout``."""
    b = y_z.shape[0]
    want = ((b, layout.y_blocks, layout.k), (b, layout.c_blocks, layout.k),
            (b, layout.c_blocks, layout.k))
    got = tuple(tuple(t.shape) for t in (y_z, cb_z, cr_z))
    if got != want:
        raise ValueError(f"coefficient planes {got} do not fit layout {layout} ({want})")
    if layout.sub not in (1, 2) or layout.k not in COEF_BUCKETS:
        raise ValueError(f"sub must be 1 or 2 and k one of {COEF_BUCKETS}, got {layout}")
    if (layout.y_gw != layout.c_gw * layout.sub or layout.y_gh != layout.c_gh * layout.sub
            or layout.width > 8 * layout.y_gw or layout.height > 8 * layout.y_gh):
        raise ValueError(f"inconsistent block grids in {layout}")


DCT_PATCHES = (8, 16)  # patch sizes KJ takes


def dct_patches(
    y_z, cb_z, cr_z, layout: FrameLayout, patch: int, dtype: torch.dtype,
    rgb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel KJ (``csrc/dct_patches.cu``): int16 coefficient planes ->
    the classifier's patches ``[B, N, patch*patch*3]`` in ``dtype``, as
    ``dct_patches_plain``. With ``rgb`` (a contiguous ``f32[B, height,
    width, 3]``) it also writes the decoded frames there (the check of
    the decode itself)."""
    if not y_z.is_cuda:
        out = dct_patches_plain(y_z, cb_z, cr_z, layout, patch, dtype)
        if rgb is not None:
            rgb.copy_(decode_frames(y_z, cb_z, cr_z, layout))
        return out
    _check_coeffs(y_z, cb_z, cr_z, layout)
    h, w = layout.height, layout.width
    if patch not in DCT_PATCHES or h % patch or w % patch:
        raise NotImplementedError(
            f"KJ takes patches of {DCT_PATCHES} that tile the frame, got {patch} on {w}x{h}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"KJ writes float32 or bfloat16 patches, not {dtype}")
    if rgb is not None and (rgb.dtype != torch.float32 or not rgb.is_contiguous()
                            or tuple(rgb.shape) != (y_z.shape[0], h, w, 3)):
        raise ValueError(f"rgb must be a contiguous f32[B, {h}, {w}, 3]")
    planes = [t.to(torch.int16).contiguous() for t in (y_z, cb_z, cr_z)]
    b = y_z.shape[0]
    n = (h // patch) * (w // patch)
    out = torch.empty((b, n, patch * patch * 3), dtype=dtype, device=y_z.device)
    p = kernels.ptr
    kernels.launch(
        "dct_patches", *(p(t) for t in planes), p(out), p(rgb), b, w, h, layout.y_gw,
        layout.y_gh, layout.c_gw, layout.c_gh, layout.sub, layout.k, patch,
        int(dtype == torch.bfloat16), kernels.stream_handle(y_z.device),
    )
    return out


def decode_rgb(y_z, cb_z, cr_z, layout: FrameLayout, patch: int,
               dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """KJ's patches and its decoded frames f32[B, height, width, 3]."""
    rgb = torch.empty((y_z.shape[0], layout.height, layout.width, 3), dtype=torch.float32,
                      device=y_z.device)
    return dct_patches(y_z, cb_z, cr_z, layout, patch, dtype, rgb=rgb), rgb

"""Depthwise 7x7 convolution (NHWC, stride 1, SAME, bias-free): the CUDA
kernel, its gradient, its plain version.

Counterpart of the JAX package's ``kernels/dwconv.py:dwconv7``. ``x`` is
``(B, H, W, C)``, ``w`` is ``(7, 7, C)`` (the model's HWIO ``(7, 7, 1, C)``
filter squeezed); the caller adds the conv bias in f32.

Numerics (kernel and plain version alike): the filter is rounded to ``x``'s
dtype first and widened to f32 (so the kernel and the library conv use the
same filter bits), the 49 taps accumulate in f32, the output is rounded once
to ``x``'s dtype. The input gradient is the same convolution of the
cotangent (cast to ``x``'s dtype) with the spatially flipped filter: the
same kernel. The filter gradient is taken only when autograd asks for it, by
the plain version's autograd; the attack path and LoRA training never do.

The plain version (:func:`dwconv7_reference`) is ``F.conv2d`` with
``groups=C`` on operands widened to f32 (on a CUDA tensor that is cuDNN's
f32 path; set ``torch.backends.cudnn.allow_tf32 = False`` to compare).

Dispatch (:func:`dwconv7`): one ``autograd.Function`` for both devices; a
CPU tensor takes the plain version in forward and backward, a CUDA tensor
launches the kernel (``csrc/dwconv7.cu``; f32 and bf16, any H and W, C a
multiple of 8) or raises. ``FWD_LAUNCHES`` counts kernel launches in the
forward role, ``DX_LAUNCHES`` in the input-gradient role, ``DW_CALLS`` the
filter-gradient recomputes.

Which device code a launch takes (:func:`kernel_variant`, the C launcher's
test): bf16 runs ``"tma_ring"`` (persistent CTAs, tiles by 4-D TMA with the
halo zero-filled, taps in registers, 2 x 7 output blocks a warp, 1 x 7 in a
tile of odd height, TMA stores), f32 keeps the first design, ``"staged"``.
:func:`kernel_plan` is the bf16 launcher's tile, schedule and ring
arithmetic in Python, :func:`item_blocks` a work item's split into the
warps' blocks; the tests hold both to covering every output once.
:func:`staged_fwd` / :func:`staged_dx` launch the first design at any dtype,
uncounted: reachable from nothing but ``chip_smoke.py`` and
``tools/dwconv_diagnose.py``, which time the two in turns and hold them bit
for bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

FWD_LAUNCHES = 0
DX_LAUNCHES = 0
DW_CALLS = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "dwconv7.cu"

# the bf16 launcher's constants (csrc/dwconv7.cu, namespace tr)
CHUNK = 64  # channels of a work item
MAX_BLOCK_ROWS, BLOCK_COLS = 2, 7  # outputs of a warp's block (1 row in a tile of odd height)
MAX_TILE_H, MAX_TILE_W = 14, 28  # outputs of a work item's tile, at most
COMPUTE_WARPS = 8
MAX_SLOTS = 8
SMEM_MAX = 232448
STAGING = 2 * COMPUTE_WARPS * MAX_BLOCK_ROWS * BLOCK_COLS * CHUNK * 2  # two store buffers a warp
SLOT_BUDGET = SMEM_MAX - 1024 - STAGING - 2 * MAX_SLOTS * 8
H100_SMS = 132


def _check_shape(shape) -> None:
    if len(shape) != 4 or min(shape) < 1:
        raise ValueError(f"dwconv7 wants x (B, H, W, C), got {tuple(shape)}")
    if shape[-1] % 8:
        raise ValueError(f"{shape[-1]} channels unsupported by the CUDA kernel "
                         f"(takes a multiple of 8)")


def kernel_variant(dtype: torch.dtype, shape) -> str:
    """Which device code of ``csrc/dwconv7.cu`` a launch on ``x`` of this dtype
    and shape ``(B, H, W, C)`` takes; the same test as the C launcher, nothing
    else chooses: ``"tma_ring"`` (bf16) or ``"staged"`` (f32, the first
    design). Raises on what no kernel takes."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {dtype} unsupported by the CUDA kernel")
    _check_shape(shape)
    return "tma_ring" if dtype == torch.bfloat16 else "staged"


def kernel_plan(shape, sms: int = H100_SMS) -> dict:
    """The bf16 launcher's plan for ``x`` of shape ``(B, H, W, C)`` on ``sms``
    SMs: tile (rows, columns of outputs), a warp's block rows, tiles along H
    and W, channel chunks, work items (channel chunk major), persistent CTAs,
    ring slots and their bytes (a haloed box rounded up to 1024), dynamic
    shared memory."""
    _check_shape(shape)
    b, h, w, c = shape
    th = min(h, MAX_TILE_H)
    tw = min(-(-w // BLOCK_COLS) * BLOCK_COLS, MAX_TILE_W)
    tiles_h, tiles_w, chunks = -(-h // th), -(-w // tw), -(-c // CHUNK)
    items = chunks * b * tiles_h * tiles_w
    slot_bytes = -(-((th + 6) * (tw + 6) * CHUNK * 2) // 1024) * 1024
    slots = min(MAX_SLOTS, SLOT_BUDGET // slot_bytes)
    return {"tile": (th, tw), "block_rows": 1 if th % 2 else MAX_BLOCK_ROWS,
            "tiles": (tiles_h, tiles_w), "chunks": chunks, "items": items,
            "grid": min(items, sms), "slots": slots, "slot_bytes": slot_bytes,
            "smem": slots * slot_bytes + STAGING + 1024 + 2 * MAX_SLOTS * 8}


def cta_items(plan: dict, cta: int) -> range:
    """The contiguous work items of persistent CTA ``cta``."""
    n, g = plan["items"], plan["grid"]
    return range(cta * n // g, (cta + 1) * n // g)


def decode_item(plan: dict, shape, i: int) -> tuple:
    """Work item ``i`` as (c0, b, h0, w0): its channel chunk, image and tile origin."""
    b = shape[0]
    tiles_h, tiles_w = plan["tiles"]
    th, tw = plan["tile"]
    tiles = tiles_h * tiles_w
    chunk, r = divmod(i, b * tiles)
    t = r % tiles
    return chunk * CHUNK, r // tiles, (t // tiles_w) * th, (t % tiles_w) * tw


def item_blocks(plan: dict, shape, h0: int, w0: int) -> list:
    """A work item's blocks as (first row, rows, first column, columns) of
    outputs relative to the tile: rows in the plan's block rows (a last
    block of fewer only where the tile ends the image), columns in strips of
    7 (the last computes past W, and its store drops what lies outside)."""
    _, h, w, _ = shape
    th, tw = plan["tile"]
    br = plan["block_rows"]
    rows, cols = min(th, h - h0), min(tw, w - w0)
    strips = -(-cols // BLOCK_COLS)
    out = []
    for k in range(-(-rows // br) * strips):
        r0, s0 = (k // strips) * br, (k % strips) * BLOCK_COLS
        out.append((r0, min(br, rows - r0), s0, min(BLOCK_COLS, cols - s0)))
    return out


def _taps_f32(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The filter rounded to ``dtype``, then widened: (7, 7, C) f32."""
    return w.to(dtype).float()


def dwconv7_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (differentiable in x and w)."""
    c = x.shape[-1]
    taps = _taps_f32(w, x.dtype).permute(2, 0, 1).reshape(c, 1, 7, 7)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), taps, None, 1, 3, 1, c)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def dwconv7_dw_reference(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Filter gradient ``(7, 7, C)`` in ``w``'s dtype, by the plain version's autograd."""
    global DW_CALLS
    DW_CALLS += 1
    with torch.enable_grad():
        wv = w.detach().requires_grad_(True)
        y = dwconv7_reference(x.detach(), wv)
        (dw,) = torch.autograd.grad(y, wv, g.to(y.dtype))
    return dw


# --- the CUDA kernel ----------------------------------------------------------

def _lib():
    from . import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_apvt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.apvt_dwconv7, lib.apvt_dwconv7_staged):
            fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
            fn.restype = i
        lib.apvt_dwconv7_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong)]
        lib.apvt_dwconv7_plan.restype = i
        lib.apvt_dwconv7_error_string.argtypes = [i]
        lib.apvt_dwconv7_error_string.restype = ctypes.c_char_p
        lib._apvt_typed = True
    return lib


def launcher_plan(shape, sms: int = 0) -> dict:
    """The C launcher's own plan (``apvt_dwconv7_plan``; the card's SM count
    where ``sms`` is 0), in :func:`kernel_plan`'s keys but ``slot_bytes``."""
    _check_shape(shape)
    out = (ctypes.c_longlong * 9)()
    if _lib().apvt_dwconv7_plan(*shape, sms, out) != 0:
        raise ValueError(f"dwconv7: unsupported shape {tuple(shape)}")
    th, tw, rows, tiles_h, tiles_w, items, grid, slots, smem = out
    return {"tile": (th, tw), "block_rows": rows, "tiles": (tiles_h, tiles_w), "items": items,
            "grid": grid, "slots": slots, "smem": smem}


def _launch(x: torch.Tensor, w: torch.Tensor, flip: bool,
            entry: str = "apvt_dwconv7") -> torch.Tensor:
    """The kernel on CUDA operands: x (B, H, W, C), w (7, 7, C), which is
    rounded to x's dtype here and widened in the kernel; ``flip`` reads it
    spatially flipped (the input-gradient role)."""
    if x.dim() != 4 or tuple(w.shape) != (7, 7, x.shape[-1]):
        raise ValueError(f"dwconv7 wants x (B, H, W, C) and w (7, 7, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    kernel_variant(x.dtype, x.shape)
    b, h, wd, c = x.shape
    taps = w.to(x.dtype).contiguous()
    for t in (x, taps):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("dwconv7 operands must share one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("dwconv7 operands must be contiguous and 16-byte aligned")
    lib = _lib()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, entry)(x.data_ptr(), taps.data_ptr(), out.data_ptr(), b, h, wd, c,
                             _DTYPE_CODE[x.dtype], int(flip), stream)
    if rc == -1:
        raise ValueError(f"dwconv7: unsupported dtype or shape {tuple(x.shape)}")
    if rc == -2:
        raise RuntimeError("dwconv7: no tensor map could be encoded for these operands")
    if rc != 0:
        msg = lib.apvt_dwconv7_error_string(rc).decode()
        raise RuntimeError(f"dwconv7 launch failed: CUDA error {rc} ({msg})")
    return out


def fused_dwconv7_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel in its forward role on CUDA tensors."""
    global FWD_LAUNCHES
    out = _launch(x, w, flip=False)
    FWD_LAUNCHES += 1
    return out


def fused_dwconv7_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel in its input-gradient role: ``g`` (already in x's
    dtype) against the filter read flipped."""
    global DX_LAUNCHES
    out = _launch(g, w, flip=True)
    DX_LAUNCHES += 1
    return out


def staged_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The first design's device code in the forward role, uncounted (for
    timing it against the kernel in turns)."""
    return _launch(x, w, flip=False, entry="apvt_dwconv7_staged")


def staged_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The first design's device code in the input-gradient role, uncounted."""
    return _launch(g, w, flip=True, entry="apvt_dwconv7_staged")


class _DwConv7(torch.autograd.Function):
    """Forward and input gradient by one function of (x, filter): the kernel
    on CUDA tensors, the plain version on CPU tensors."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return dwconv7_reference(x, w)
        return fused_dwconv7_fwd(x.contiguous(), w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (dwconv7_reference(g, w.flip(0, 1)) if g.device.type == "cpu"
                  else fused_dwconv7_dx(g, w))
        dw = dwconv7_dw_reference(x, w, g) if ctx.needs_input_grad[1] else None
        return dx, dw


def dwconv7(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise 7x7 SAME convolution: the kernel for CUDA tensors (forward
    and input gradient), the plain version on the CPU."""
    return _DwConv7.apply(x, w)

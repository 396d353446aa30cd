"""What limits the LayerNorm-fused MLP kernels on the card: time them with one
part of the work taken out at a time.

Builds ``csrc/ln_mlp.cu`` and edited copies of it (the copies compute wrong
values; they exist only to be timed):

* ``no gelu``: ``erff``/``expf`` replaced by a multiply (the cost of the
  exact GELU on the CUDA cores);
* ``no weight loads``: the cp.async copies of the weight slabs from L2
  skipped (the cost of streaming the weights once per CTA);
* ``no mma``: every ``mma.sync`` replaced by four adds (whether the tensor
  cores are on the critical path at all);
* ``no ldmatrix``: every ``ldmatrix`` replaced by register moves (the cost
  of feeding the fragments from shared memory);
* ``no barriers``: every ``__syncthreads`` replaced by ``__syncwarp`` (the
  cost of the two block-wide barriers per weight slab; the copy races).

Each variant runs forward and backward at the ConvNeXt-B stage shapes
(B=64), in two turns, CUDA events over 20 launches; one line per variant and
turn, with the card's name and power limit.

Run on a machine with a CUDA card, from the repository root:
``python3 -m apvt_lora_torch.tools.ln_mlp_diagnose``.
"""

from __future__ import annotations

import re
import subprocess

SHAPES = ((200704, 128, 512), (12544, 512, 2048), (3136, 1024, 4096))  # (T, D, M)

_GELU = "return 0.5f * pre * (1.f + erff(pre * 0.7071067811865476f));"
_GELU_GRAD = """  const float phi = expf(-0.5f * pre * pre) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.f + erff(pre * 0.7071067811865476f));
  return cdf + pre * phi;"""
_COPY = "    cp_async16(dst + r * (COLS + 8) + c * 8, src + (size_t)r * ld + c * 8);"
_LDSM = re.compile(r'  asm volatile\("ldmatrix\.sync.*?\(smem_addr\(p\)\)\);', re.S)
_MMA = re.compile(r'  asm(?: volatile)?\(\n      "mma\.sync.*?\(b1\)\);', re.S)


def variants(text: str) -> dict[str, str]:
    """``{label: source}``; raises if an edit no longer finds its place."""
    out = {"kernel": text}
    out["no gelu"] = text.replace(_GELU, "return 0.5f * pre;").replace(
        _GELU_GRAD, "  return 0.5f + pre;")
    out["no weight loads"] = text.replace(_COPY, "    if (blockIdx.x > 0x7ffffff0u) " + _COPY.strip())
    out["no mma"] = _MMA.sub(
        "  d[0] += __uint_as_float(a[0] ^ b0); d[1] += __uint_as_float(a[1] ^ b1);\n"
        "  d[2] += __uint_as_float(a[2]); d[3] += __uint_as_float(a[3]);", text)
    out["no ldmatrix"] = _LDSM.sub("  r[0] = r[1] = r[2] = r[3] = smem_addr(p);", text)
    out["no barriers"] = text.replace("__syncthreads();", "__syncwarp();")
    same = [k for k, v in out.items() if k != "kernel" and v == text]
    if same:
        raise RuntimeError(f"ln_mlp.cu changed: the edits for {same} found nothing to replace")
    return out


def main() -> None:
    import torch

    from ..kernels import _build
    from ..kernels import mlp as km

    if not torch.cuda.is_available():
        raise SystemExit("ln_mlp_diagnose: this needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sources = variants(_build.inlined("ln_mlp.cu"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)

    def rand(*size):
        return torch.randn(*size, device=dev, generator=gen)

    operands = {}
    for t, d, m in SHAPES:
        operands[t, d, m] = (rand(t, d).to(torch.bfloat16), rand(t, d).to(torch.bfloat16),
                             1.0 + 0.5 * rand(d), 0.5 * rand(d),
                             (rand(d, m) * d ** -0.5).to(torch.bfloat16), 0.5 * rand(m),
                             (rand(m, d) * m ** -0.5).to(torch.bfloat16), 0.5 * rand(d))

    def ms(fn, iters=20):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    saved = km._lib
    try:
        for turn in (1, 2):
            for label, text in sources.items():
                lib = _build.load_text("ln_mlp_diagnose.cu", text)
                km._lib = lambda lib=lib: _typed(lib, saved)
                cells = []
                for shape, (x, dy, s, b, w1, b1, w2, b2) in operands.items():
                    fwd = ms(lambda: km.fused_ln_mlp_fwd(x, s, b, w1, b1, w2, b2, 1e-6))
                    bwd = ms(lambda: km.fused_ln_mlp_bwd(x, s, b, w1, b1, w2, dy, 1e-6))
                    cells.append(f"{shape} fwd {fwd:.4f} ms bwd {bwd:.4f} ms")
                print(f"ln_mlp_diagnose turn {turn} {label:16s}: " + "; ".join(cells)
                      + f" [{card}]", flush=True)
    finally:
        km._lib = saved


def _typed(lib, typed_loader):
    """Give ``lib`` the argument types of the real library's entry points."""
    if not getattr(lib, "_apvt_typed", False):
        real = typed_loader()
        for name in ("apvt_ln_mlp_fwd", "apvt_ln_mlp_bwd", "apvt_ln_mlp_error_string"):
            getattr(lib, name).argtypes = getattr(real, name).argtypes
            getattr(lib, name).restype = getattr(real, name).restype
        lib._apvt_typed = True
    return lib


if __name__ == "__main__":
    main()

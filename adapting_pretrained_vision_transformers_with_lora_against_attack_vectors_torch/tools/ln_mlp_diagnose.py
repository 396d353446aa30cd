"""What limits the fused MLP kernels on the card: time them with one part of
the work taken out at a time.

Builds ``csrc/ln_mlp.cu`` and edited copies of it (the copies compute wrong
values; they exist only to be timed):

* ``no gelu``: ``erff``/``expf`` replaced by a multiply (the cost of the
  exact GELU on the CUDA cores between the products);
* ``no weight loads``: the TMA loads of the weight boxes replaced by a credit
  of their bytes to the stage's barrier (the cost of streaming the weights
  from L2 once per 64 token rows: the ring's barriers and the producer stay);
* ``no mma``: every ``wgmma.mma_async`` replaced by one add (whether the
  tensor cores, and the shared-memory reads that feed them, are on the
  critical path at all);
* ``no chunk wait``: the consumers do not wait for the other warpgroups'
  slices of a hidden chunk (the cost of the one meeting point per chunk; the
  copy races).

Each variant runs the LayerNorm-fused forward and backward at three
ConvNeXt-B stage shapes (B=64) and at the ViT-B/16 shape, in two turns, CUDA
events over 20 launches; one line per variant and turn, with the card's name
and power limit.

Run on a machine with a CUDA card, from the repository root:
``python3 -m apvt_lora_torch.tools.ln_mlp_diagnose``.
"""

from __future__ import annotations

import subprocess

SHAPES = ((200704, 128, 512), (12544, 512, 2048), (3136, 1024, 4096),
          (12608, 768, 3072))  # (T, D, M)

_GELU = "return 0.5f * pre * (1.f + erff(pre * 0.7071067811865476f));"
_GELU_GRAD = """  const float phi = expf(-0.5f * pre * pre) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.f + erff(pre * 0.7071067811865476f));
  return cdf + pre * phi;"""
_LOAD = "  tma_load_2d(dst, map, bar, c0, c1);\n}"
_MMA = "  Wgmma<N>::template ss<0, TB>(d, a, b, acc);"
_WAIT = "  mbar_wait_cluster(&bars->hfull[buf], use & 1);"


def variants(text: str) -> dict[str, str]:
    """``{label: source}``; raises if an edit no longer finds its place."""
    out = {"kernel": text}
    out["no gelu"] = text.replace(_GELU, "return 0.5f * pre;").replace(
        _GELU_GRAD, "  return 0.5f + pre;")
    out["no weight loads"] = text.replace(_LOAD, "  mbar_complete_tx(bar, bytes);\n}")
    out["no mma"] = text.replace(
        _MMA, "  d[0] = __uint_as_float((uint32_t)(a ^ b)) + (acc ? d[0] : 0.f);")
    out["no chunk wait"] = text.replace(_WAIT, "")
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

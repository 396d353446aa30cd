"""Where the LN-fused MLP kernels' outputs part from the plain version's:
their LayerNorm prologue, under many input draws.

Builds ``csrc/ln_mlp.cu`` and edited copies of its LayerNorm prologue (the
copies compute the same function with other rounding points):

* ``contracted``: ``tiles.cuh:ln_affine`` written as ``xc * rstd * scale +
  bias``, which the compiler contracts into one FMA (one rounding where the
  plain version rounds twice);
* ``squares and var + eps rounded``: the kernel with, besides, each square
  and the variance plus eps rounded on its own, as the plain version rounds
  them.

Each runs the LN-fused forward at (50176, 256, 1024) and at the ConvNeXt-B
stage-1 shape (200704, 128, 512) under the 8 input draws of
``chip_smoke.py``'s ``ln_mlp_seeds`` (the same operands, drawn the same way
from generators seeded 100-107). One line per build, shape and draw: the
outputs over the limit MLP_TOL (1e-2 + 1e-2 |y|), the h values (the
prologue's bf16 output, read through ``apvt_ln_mlp_ln_rows``) that differ
from the plain version's, the rows whose rstd and mean differ from its in
any bit, and the largest difference of the forward from the plain version
fed the kernel's own h (0: everything after the prologue is exact).

Run on a machine with a CUDA card, from the repository root:
``python3 -m apvt_lora_torch.tools.ln_prologue_diagnose``.
"""

from __future__ import annotations

import re
import subprocess

SHAPES = ((50176, 256, 1024), (200704, 128, 512))  # (T, D, M)
SEEDS = tuple(range(100, 108))
PARAM_STD = 0.5
EPS = 1e-6

_AFFINE = "  return __fadd_rn(__fmul_rn(__fmul_rn(xc, rstd), scale), bias);"
_SQUARE = "sq += v[p][e] * v[p][e];"
_VAR = re.compile(r"rsqrtf\((\w+)\(sq\) \* \(1\.f / D\) \+ eps\)")


def variants(text: str) -> dict[str, str]:
    """``{label: source}`` from the text of ``csrc/ln_mlp.cu`` with its
    headers inlined; raises if an edit no longer finds its place."""
    if _AFFINE not in text or _SQUARE not in text or not _VAR.search(text):
        raise RuntimeError("ln_mlp.cu changed: an edit of ln_prologue_diagnose found nothing")
    rounded = _VAR.sub(r"rsqrtf(__fadd_rn(__fmul_rn(\1(sq), 1.f / D), eps))",
                       text.replace(_SQUARE, "sq += __fmul_rn(v[p][e], v[p][e]);"))
    return {"kernel": text,
            "contracted": text.replace(_AFFINE, "  return xc * rstd * scale + bias;"),
            "squares and var + eps rounded": rounded}


def operands(shape, seed: int, dev):
    """``chip_smoke.Smoke.mlp_operands`` drawn from a generator seeded ``seed``."""
    import torch

    t, d, m = shape
    gen = torch.Generator(dev).manual_seed(seed)

    def rand(*size):
        return torch.randn(*size, device=dev, generator=gen)

    x = (rand(t, d) + 0.5 * rand(t, 1)).to(torch.bfloat16)
    rand(t, d)  # the cotangent of chip_smoke's draw, unused here
    return x, {"ln_scale": 1.0 + PARAM_STD * rand(d), "ln_bias": PARAM_STD * rand(d),
               "w1": rand(d, m) * d ** -0.5, "b1": PARAM_STD * rand(m),
               "w2": rand(m, d) * m ** -0.5, "b2": PARAM_STD * rand(d)}


def main() -> None:
    import torch

    from ..kernels import _build
    from ..kernels import mlp as km

    if not torch.cuda.is_available():
        raise SystemExit("ln_prologue_diagnose: this needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sources = variants(_build.inlined("ln_mlp.cu"))
    from concurrent.futures import ThreadPoolExecutor

    names = {label: f"ln_prologue_diagnose_{i}.cu" for i, label in enumerate(sources)}
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(lambda kv: _build.load_text(names[kv[0]], kv[1]),
                                          sources.items())))
    saved = km._lib
    real = saved()
    dev, cd = torch.device("cuda", 0), torch.bfloat16
    try:
        for label, lib in libs.items():
            for name in ("apvt_ln_mlp_fwd", "apvt_ln_mlp_ln_rows", "apvt_ln_mlp_error_string"):
                getattr(lib, name).argtypes = getattr(real, name).argtypes
                getattr(lib, name).restype = getattr(real, name).restype
            km._lib = lambda lib=lib: lib
            for shape in SHAPES:
                for seed in SEEDS:
                    x, p = operands(shape, seed, dev)
                    args = (p["ln_scale"], p["ln_bias"], p["w1"], p["b1"], p["w2"], p["b2"], EPS)
                    got = km.fused_ln_mlp_fwd(x, *args)
                    want = km.ln_mlp_reference(x, *args)
                    h_k, mean_k, rstd_k = km.kernel_ln_rows(x, p["ln_scale"], p["ln_bias"], EPS)
                    _, rstd_p, h_p = km.ln_fwd_f32(x.float(), p["ln_scale"], p["ln_bias"], EPS)
                    pre = km._mm_f32(h_k, p["w1"].to(cd)) + p["b1"]
                    given = (km._mm_f32(km._gelu_f32(pre).to(cd), p["w2"].to(cd))
                             + p["b2"]).to(cd)
                    over = int(((got.float() - want.float()).abs()
                                > 1e-2 + 1e-2 * want.float().abs()).sum())
                    print(f"ln_prologue_diagnose {label}: {shape} seed {seed}: {over} outputs "
                          f"over MLP_TOL; h differs from plain in "
                          f"{int((h_k != h_p.to(cd)).sum())} of {h_k.numel()} values; rows with "
                          f"other rstd bits {int((rstd_k != rstd_p[:, 0]).sum())}, mean bits "
                          f"{int((mean_k != x.float().mean(-1)).sum())}; forward vs the plain "
                          f"version fed the kernel's h max|err| "
                          f"{float((got.float() - given.float()).abs().max()):.3e} [{card}]",
                          flush=True)
    finally:
        km._lib = saved


if __name__ == "__main__":
    main()

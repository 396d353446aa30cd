"""What limits packed attention's CUDA-core device code on the card (the
``"cuda_core"`` variant: f32, and bf16 with N > 256): time it beside edited
copies of itself.

Builds ``csrc/attention_packed.cu`` and edited copies of it:

* ``fast exp``: ``__expf`` in place of ``expf`` in the variant (what the
  accurate exponential costs);
* ``no P.V``: the forward without its second product (the scores, the
  online softmax and the P stores alone; wrong values);
* ``no S product``: the forward's scores read from shared memory instead of
  computed (the softmax and P.V alone; wrong values);
* ``no refills``: the forward's ring never refilled after its first block
  (the K/V traffic taken out; wrong values);
* ``A loads hoisted`` and ``B loads hoisted``: the score products read one
  float4 of their own-row (A) or streamed-row (B) operand for every k step
  (the loop's shared loads of that operand taken out; wrong values);
* ``forward: 8 rows a thread`` and ``backward: 4 rows a thread``: the other
  thread tile height in each pass (forward: 4 warps a CTA at 168 registers;
  backward: 16 warps a CTA capped at 128 registers);
* ``dQ role alone`` and ``dK/dV role alone``: the backward with the CTAs of
  the other role returning at once (wrong values for their gradients);
* ``backward: no exp``: both roles' P taken as the raw score (wrong values);
* ``dK/dV: no D``: the dK, dV role without its per-block D pass and barrier;
* ``dK/dV: no dK product``: the dK, dV role without its last product.

The exact copies (the kernel and the two other tile heights) are held bit
for bit against the kernel at the parity shape. Then every build takes turns at
``SHAPES`` (CUDA events around 20 calls, best of 3), one line a shape and
pass with each time's share of the f32 FMA bound.

Run on a machine with a CUDA card, from the repository root:
``python3 -m apvt_lora_torch.tools.attention_diagnose``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess

# (B, N, H, hd) f32: phase 12's parity shape (ViT-B/224, 24 images) and ViT-B/16
# at 384 px (N = 577)
SHAPES = ((24, 197, 12, 64), (8, 577, 12, 64))
PEAK_F32 = 67e12

_CC = re.compile(r"namespace cc \{.*?\}  // namespace cc\n", re.S)
_PV = "    acc_nn<HD>(acc, X, Ks + kBlock * S + E * c, (nk + 3) & ~3);\n"
_S = "  dot_nt<HD>(s, A, Ks + c * S, (nk + 15) >> 4);\n"
_S_READ = """#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[m][j] = A[2 * m * S + 16 * j + c];
"""
_REFILL = "    if (it + 1 < total) {\n      const int next = (it + 1) % nblk;"
_DELTA = "    block_delta<HD, kBlock>(Dq, dOb, dOb + kBlock * S);\n"
_DK = "      acc_nn<HD>(dk_acc, X, Qb + E * c, (nq + 3) & ~3);\n"
_A_LOAD = "a[m] = *reinterpret_cast<const float4*>(A + 2 * m * S + d);"
_B_LOAD = "b[j] = *reinterpret_cast<const float4*>(B + 16 * j * S + d);"
_TILES = "constexpr int kFwdTR = 4, kBwdTR = 8;"
_DKDV = "    bwd_dkdv<T, HD>(q, k, v, dout, out, lse, dk, dv, N, H, lay, scale, blockIdx.x);"
_DQ = "    bwd_dq<T, HD>(q, k, v, dout, out, lse, dq, N, H, lay, scale, blockIdx.x - nrb);"


def _replace(text: str, old: str, new: str, label: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"attention_packed.cu changed: the edit for {label!r} found nothing "
                           f"to replace")
    return text.replace(old, new)


def _in_cc(text: str, old: str, new: str, label: str) -> str:
    """``old`` replaced by ``new`` inside the CUDA-core variant's namespace only."""
    m = _CC.search(text)
    if m is None or old not in m.group(0):
        raise RuntimeError(f"attention_packed.cu changed: the edit for {label!r} found nothing "
                           f"to replace")
    return text[:m.start()] + m.group(0).replace(old, new) + text[m.end():]


def variants(text: str) -> dict[str, str]:
    """``{label: source}`` from the text of ``csrc/attention_packed.cu`` with
    its headers inlined; raises if an edit no longer finds its place."""
    no_exp = _replace(text, "prob(s[m][j], scale, L[m])", "s[m][j]", "backward: no exp")
    return {
        "kernel": text,
        "fast exp": _in_cc(text, "expf(", "__expf(", "fast exp"),
        "no P.V": _replace(text, _PV, "", "no P.V"),
        "no S product": _replace(text, _S, _S_READ, "no S product"),
        "no refills": _replace(text, _REFILL, _REFILL.replace("it + 1 < total", "false", 1),
                               "no refills"),
        "A loads hoisted": _replace(text, _A_LOAD, _A_LOAD.replace(" + d)", ")"),
                                    "A loads hoisted"),
        "B loads hoisted": _replace(text, _B_LOAD, _B_LOAD.replace(" + d)", ")"),
                                    "B loads hoisted"),
        "forward: 8 rows a thread": _replace(text, _TILES,
                                             "constexpr int kFwdTR = 8, kBwdTR = 8;",
                                             "forward: 8 rows a thread"),
        "backward: 4 rows a thread": _replace(text, _TILES,
                                              "constexpr int kFwdTR = 4, kBwdTR = 4;",
                                              "backward: 4 rows a thread"),
        "dQ role alone": _replace(text, _DKDV, "    return;", "dQ role alone"),
        "dK/dV role alone": _replace(text, _DQ, "    return;", "dK/dV role alone"),
        "backward: no exp": _replace(no_exp, "prob(st[m][j], scale, lq[j])", "st[m][j]",
                                     "backward: no exp"),
        "dK/dV: no D": _replace(text, _DELTA, "", "dK/dV: no D"),
        "dK/dV: no dK product": _replace(text, _DK, "", "dK/dV: no dK product"),
    }


EXACT = ("kernel", "forward: 8 rows a thread", "backward: 4 rows a thread")


def main() -> None:
    import torch

    from ..kernels import _build
    from ..kernels import attention as ka
    from .timing import cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("attention_diagnose: this needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sources = variants(_build.inlined("attention_packed.cu"))
    names = {label: f"attention_diagnose_{i}.cu" for i, label in enumerate(sources)}
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(lambda kv: _build.load_text(names[kv[0]], kv[1]),
                                          sources.items())))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for label, lib in libs.items():
        lib.apvt_attn_packed_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
        lib.apvt_attn_packed_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, p]
        log = _build.BUILD_LOG.get(names[label], "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
        print(f"{label}: registers {min(regs, default=0)}-{max(regs, default=0)} over "
              f"{len(regs)} kernels, spill stores {spills} bytes", flush=True)

    def fwd(lib, q, k, v, h):
        b, n, c = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
        rc = lib.apvt_attn_packed_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                      lse.data_ptr(), b, n, h, c // h, 0, (c // h) ** -0.5,
                                      torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"forward launch failed: {rc}")
        return o, lse

    def bwd(lib, q, k, v, do, o, lse, h):
        b, n, c = q.shape
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        rc = lib.apvt_attn_packed_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                      o.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                      dv.data_ptr(), b, n, h, c // h, 0, (c // h) ** -0.5,
                                      torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"backward launch failed: {rc}")
        return dq, dk, dv

    for shape in SHAPES:
        b, n, h, hd = shape
        gen = torch.Generator("cuda").manual_seed(16)
        q, k, v, do = (torch.randn(b, n, h * hd, device="cuda", generator=gen) for _ in range(4))
        o, lse = ka.fused_attention_packed_fwd(q, k, v, h, with_lse=True)
        grads = ka.fused_attention_packed_bwd(q, k, v, do, h, o, lse)
        if shape == SHAPES[0]:
            for label in EXACT:
                got = fwd(libs[label], q, k, v, h)
                again = bwd(libs[label], q, k, v, do, o, lse, h)
                if not (torch.equal(got[0], o) and torch.equal(got[1], lse)
                        and all(torch.equal(a, w) for a, w in zip(again, grads))):
                    raise RuntimeError(f"{label} is not the kernel bit for bit at {shape}")
        unit = b * h * n * n * hd
        for what, flop, call in (
                ("fwd", 4 * unit, lambda lib: fwd(lib, q, k, v, h)),
                ("bwd", 10 * unit, lambda lib: bwd(lib, q, k, v, do, o, lse, h))):
            best = {}
            for _ in range(3):
                for label, lib in libs.items():
                    ms = cuda_ms(lambda: call(lib), 20)
                    best[label] = min(best.get(label, ms), ms)
            bound = flop / PEAK_F32 * 1e3
            print(f"attention_diagnose {shape} f32 {what} (ms, share of the f32 FMA bound "
                  f"{bound:.4f} ms): " + "; ".join(f"{label} {ms:.4f} ({bound / ms:.1%})"
                                                   for label, ms in best.items())
                  + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()

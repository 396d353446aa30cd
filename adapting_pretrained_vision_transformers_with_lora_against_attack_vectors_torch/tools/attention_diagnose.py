"""What limits packed attention's streamed device codes on the card: the
``"cuda_core"`` variant (f32, and bf16 hd 32 past N = 256) and the
``"wgmma_stream"`` variant (bf16 hd 64: the backward at every N, the forward
past N = 256). Time each beside edited copies of itself.

Builds ``csrc/attention_packed.cu`` and edited copies of it. Of the
CUDA-core code (namespace ``cc``):

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

Of the streamed tensor-core code (``csrc/attn_stream.cuh``, namespace
``wgs``):

* ``stream: forward 2 ring stages`` and ``stream: backward 2 ring stages``:
  the TMA ring shallower than its 4 (forward) or 3 (backward) stages;
* ``stream: forward 1 warpgroup a CTA`` (a 2-stage ring, five CTAs an SM)
  and ``stream: backward 2 warpgroups a CTA`` (a 4-stage ring, the
  backward's first design): the other CTA shape of each kernel (the same
  values);
* ``stream: forward 3 CTAs an SM``: a 3-stage forward ring with the
  register cap of three CTAs an SM (80 registers: it spills);
* ``stream: lane-0 release``: one arrive a warp on the ring's empty
  barriers in place of one a thread (ptxas then serialises the forward's
  wgmma, warning C7520);
* ``stream: dQ role alone`` and ``stream: dK/dV role alone``: the backward
  with the CTAs of the other role returning at once (wrong values for their
  gradients);
* ``stream: backward without its pre-pass``: the launcher without the
  ``stream_stats`` launch (its lse2 and D read from a buffer it never
  wrote: wrong values; what the pre-pass costs);
* ``stream: backward roles in two halves``: the backward's grid with every
  dK/dV CTA before every dQ CTA (a head's two roles half a launch apart)
  in place of a head's CTAs of both roles side by side (the same values);
* ``stream: backward first pre-pass``: ``stream_stats`` as it was first
  written, a warp a row and 4 bytes of dO and of O a lane, each row's
  loads awaited in turn (the same values);
* ``stream: backward as first built``: the two above at once, the
  backward as the N > 256 route first ran it (the same values).

A shape is timed, in each direction, with the kernel and the edits of the
variant that direction takes (:func:`edits_at`): the ``cc`` edits at the
f32 shapes, the ``wgs`` edits at the bf16 ones (at N = 197 the backward
only: the forward there is the whole-head ``"wgmma"`` code, which no edit
changes). The exact copies among them (the other tile heights, ring
depths, CTA shapes, barrier counts and CTA order) are held bit for bit
against the kernel at every shape. Then the builds take turns (device time
by CUDA-graph replay of 20 calls, best of 3), one line a shape and pass
with each time's share of the bound (f32: the FMA rate; bf16: the larger of
the tensor-core rate and the bytes).

:func:`planted_faults` are three more copies of the streamed code, each
with one 64-row block skipped (the forward's second pass, the dQ role, the
dK/dV role): ``chip_smoke.py --mutants`` shows that its limits for the
route fail each one.

Run on a machine with a CUDA card, from the repository root:
``python3 -m apvt_lora_torch.tools.attention_diagnose`` (``--variant
wgmma_stream`` or ``--variant cuda_core``: that variant's edits and shapes
alone).
"""

from __future__ import annotations

import ctypes
import re

# (B, N, H, hd, dtype): phase 12's parity shape (ViT-B/224, 24 images) and ViT-B/16 at
# 384 px (N = 577) in f32 (the CUDA-core code), then ViT-B/16 at 384 px and at 224 px
# (the main path: B = 64, N = 197) in bf16 (the streamed tensor-core code)
SHAPES = ((24, 197, 12, 64, "float32"), (8, 577, 12, 64, "float32"),
          (8, 577, 12, 64, "bfloat16"), (64, 197, 12, 64, "bfloat16"))
PEAK_F32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12

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
_WGS = re.compile(r"namespace wgs \{.*?\}  // namespace wgs\n", re.S)
_FWD_STAGES, _BWD_STAGES = "constexpr int kFwdStages = 4;", "constexpr int kBwdStages = 3;"
_FWD_WGS, _BWD_WGS = "constexpr int kFwdWarpgroups = 2;", "constexpr int kBwdWarpgroups = 1;"
_FWD_CTAS = "constexpr int kFwdCtasPerSm = 2;"
_EMPTY = "mbar_init(&empty[s], 128 * nwg);"
_FWD_RELEASE = "auto release = [&] { mbar_arrive(&empty[s]); };"
_BWD_RELEASE = "      mbar_arrive(&empty[s]);\n    }\n"
_LANE0 = "if ((threadIdx.x & 31) == 0) "
_ROLE = "  const bool kv = r < ZS;\n"
_STATS = "  stream_stats<<<B * H * nb, kStatThreads, 0, stream>>>("
_ORDER = ("  const int bh = blockIdx.x / (2 * ZS), r = blockIdx.x % (2 * ZS);\n"
          "  const bool kv = r < ZS;\n"
          "  const int z = kv ? r : r - ZS;\n")
_NEW_STATS = re.compile(r"constexpr int kStatThreads = 128;\n.*?\n}\n", re.S)
_FIRST_STATS = """constexpr int kStatThreads = 256;

__global__ void __launch_bounds__(kStatThreads)
stream_stats(const bf16* __restrict__ dout, const bf16* __restrict__ out,
             const float* __restrict__ lse, float* __restrict__ work, Strides st, int N, int H) {
  const int NB = (N + kBlock - 1) / kBlock;
  const int bh = blockIdx.x / NB, i = blockIdx.x % NB, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* w = work + (size_t)blockIdx.x * 2 * kBlock;
  const size_t hb = (size_t)b * st.batch + (size_t)h * st.head;
  for (int r = warp; r < kBlock; r += 8) {
    const int row = i * kBlock + r;
    float d = 0.f, l2 = INFINITY;
    if (row < N) {
      const size_t off = hb + (size_t)row * st.row + 2 * lane;
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + off));
      d = x.x * y.x + x.y * y.y;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      l2 = lse[(size_t)bh * N + row] * kLog2e;
    }
    if (lane == 0) {
      w[r] = l2;
      w[kBlock + r] = d;
    }
  }
}
"""
_HALVES = ("  const int per = gridDim.x / 2;\n"
           "  const bool kv = (int)blockIdx.x < per;\n"
           "  const int x = kv ? blockIdx.x : blockIdx.x - per;\n"
           "  const int bh = x / ZS, z = x % ZS;\n")


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


def _in_wgs(text: str, old: str, new: str, label: str, count: int = 1) -> str:
    """``old`` (``count`` times) replaced by ``new`` inside the streamed
    variant's namespace only."""
    m = _WGS.search(text)
    if m is None or m.group(0).count(old) != count:
        raise RuntimeError(f"attention_packed.cu changed: the edit for {label!r} found nothing "
                           f"to replace")
    return text[:m.start()] + m.group(0).replace(old, new) + text[m.end():]


def _edit_wgs(text: str, label: str, edits) -> str:
    """Each (old, new[, count]) of ``edits`` made in turn inside the streamed
    variant."""
    for old, new, *count in edits:
        text = _in_wgs(text, old, new, label, *count)
    return text


def _first_stats(text: str, label: str) -> str:
    """The pre-pass ``stream_stats`` as first written, in place of its
    16-byte-load form."""
    m = _WGS.search(text)
    found = _NEW_STATS.findall(m.group(0)) if m else []
    if len(found) != 1 or "stream_stats(" not in found[0]:
        raise RuntimeError(f"attention_packed.cu changed: the edit for {label!r} found nothing "
                           f"to replace")
    return _in_wgs(text, found[0], _FIRST_STATS, label)


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
        "stream: forward 2 ring stages": _in_wgs(text, _FWD_STAGES,
                                                 "constexpr int kFwdStages = 2;",
                                                 "stream: forward 2 ring stages"),
        "stream: backward 2 ring stages": _in_wgs(text, _BWD_STAGES,
                                                  "constexpr int kBwdStages = 2;",
                                                  "stream: backward 2 ring stages"),
        "stream: forward 1 warpgroup a CTA": _edit_wgs(text, "stream: forward 1 warpgroup a CTA", (
            (_FWD_WGS, "constexpr int kFwdWarpgroups = 1;"),
            (_FWD_STAGES, "constexpr int kFwdStages = 2;"),
            (_FWD_CTAS, "constexpr int kFwdCtasPerSm = 5;"))),
        "stream: backward 2 warpgroups a CTA": _edit_wgs(
            text, "stream: backward 2 warpgroups a CTA",
            ((_BWD_WGS, "constexpr int kBwdWarpgroups = 2;"),
             (_BWD_STAGES, "constexpr int kBwdStages = 4;"))),
        "stream: forward 3 CTAs an SM": _edit_wgs(text, "stream: forward 3 CTAs an SM", (
            (_FWD_STAGES, "constexpr int kFwdStages = 3;"),
            (_FWD_CTAS, "constexpr int kFwdCtasPerSm = 3;"))),
        "stream: lane-0 release": _edit_wgs(text, "stream: lane-0 release", (
            (_EMPTY, "mbar_init(&empty[s], 4 * nwg);", 2),
            (_FWD_RELEASE, _FWD_RELEASE.replace("{ mbar", "{ " + _LANE0 + "mbar"), 2),
            (_BWD_RELEASE, _LANE0.join(("      ", _BWD_RELEASE[6:])), 2))),
        "stream: dQ role alone": _in_wgs(text, _ROLE, _ROLE + "  if (kv) return;\n",
                                         "stream: dQ role alone"),
        "stream: dK/dV role alone": _in_wgs(text, _ROLE, _ROLE + "  if (!kv) return;\n",
                                            "stream: dK/dV role alone"),
        "stream: backward without its pre-pass": _in_wgs(
            text, _STATS, "  if (false) stream_stats<<<B * H * nb, kStatThreads, 0, stream>>>(",
            "stream: backward without its pre-pass"),
        "stream: backward roles in two halves": _in_wgs(
            text, _ORDER, _HALVES, "stream: backward roles in two halves"),
        "stream: backward first pre-pass": _first_stats(text, "stream: backward first pre-pass"),
        "stream: backward as first built": _in_wgs(
            _first_stats(text, "stream: backward as first built"), _ORDER, _HALVES,
            "stream: backward as first built"),
    }


# the variant whose namespace an edit changes; "kernel" is timed at every shape
NAMESPACE = {"cuda_core": "cc", "wgmma_stream": "wgs"}


def edits_at(labels, variant: str) -> list[str]:
    """The labels timed at a shape of ``variant``: the kernel and the edits
    of that variant's namespace (a ``stream:`` label edits ``wgs``, any other
    ``cc``); the other edits run that shape's code unchanged."""
    ns = NAMESPACE[variant]
    return [label for label in labels
            if label == "kernel" or ("wgs" if label.startswith("stream:") else "cc") == ns]


# one 64-row block (the fourth) skipped in the streamed route: the forward's
# second pass (its ring stage still released), the dQ role's keys, the dK/dV
# role's queries. Wrong values only; every barrier is kept, so none hangs
_PASS2 = "    by_width(j, NB, NL, [&](auto w) {\n      pv_block"
_DQ_LOOP = "      by_width(j, NB, NL, [&](auto w) {\n        wg::dq_block"
_DKV_LOOP = "      by_width(i, NB, NL, [&](auto w) {\n        wg::dkv_block"


def planted_faults(text: str) -> dict[str, str]:
    """``{label: source}``: the three faults, each a copy of ``text`` (the
    inlined ``csrc/attention_packed.cu``); raises if an edit no longer finds
    its place."""
    return {
        "forward skips key block 3": _in_wgs(
            text, _PASS2, "    if (j == 3) release(); else " + _PASS2[4:],
            "forward skips key block 3"),
        "dQ role skips key block 3": _in_wgs(
            text, _DQ_LOOP, "      if (j != 3) " + _DQ_LOOP[6:], "dQ role skips key block 3"),
        "dK/dV role skips query block 3": _in_wgs(
            text, _DKV_LOOP, "      if (i != 3) " + _DKV_LOOP[6:],
            "dK/dV role skips query block 3"),
    }


def bind(lib) -> None:
    """The packed entries' C signatures on a library built from an edited copy."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.apvt_attn_packed_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
    lib.apvt_attn_packed_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, p]


def launch_fwd(lib, q, k, v, h: int):
    """The packed forward of ``lib`` on packed CUDA operands: ``(o, lse)``."""
    import torch

    from ..kernels import attention as ka

    b, n, c = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    rc = lib.apvt_attn_packed_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  lse.data_ptr(), b, n, h, c // h, ka._DTYPE_CODE[q.dtype],
                                  (c // h) ** -0.5, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"forward launch failed: {rc}")
    return o, lse


def launch_bwd(lib, q, k, v, do, o, lse, h: int, work):
    """The packed backward of ``lib`` from the forward's ``o`` and ``lse``
    (``work``: the streamed route's scratch, ``kernels/attention.
    stream_work_floats`` f32): ``(dq, dk, dv)``."""
    import torch

    from ..kernels import attention as ka

    b, n, c = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    rc = lib.apvt_attn_packed_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                  o.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
                                  dk.data_ptr(), dv.data_ptr(), b, n, h, c // h,
                                  ka._DTYPE_CODE[q.dtype], (c // h) ** -0.5,
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"backward launch failed: {rc}")
    return dq, dk, dv


EXACT = ("kernel", "forward: 8 rows a thread", "backward: 4 rows a thread",
         "stream: forward 2 ring stages", "stream: backward 2 ring stages",
         "stream: forward 1 warpgroup a CTA", "stream: backward 2 warpgroups a CTA",
         "stream: forward 3 CTAs an SM", "stream: lane-0 release",
         "stream: backward roles in two halves", "stream: backward first pre-pass",
         "stream: backward as first built")


def main(argv=None) -> None:
    import argparse

    import torch

    from ..kernels import _build
    from ..kernels import attention as ka
    from .timing import card_line, graph_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=tuple(NAMESPACE), default=None,
                    help="build and time only this variant's edits, at the shapes where a "
                         "direction takes it (default: both variants)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_diagnose: this needs a CUDA card")
    card = card_line()
    sources = variants(_build.inlined("attention_packed.cu"))
    if args.variant:
        sources = {label: sources[label] for label in edits_at(sources, args.variant)}
    names = {label: f"attention_diagnose_{i}.cu" for i, label in enumerate(sources)}
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(lambda kv: _build.load_text(names[kv[0]], kv[1]),
                                          sources.items())))
    for label, lib in libs.items():
        bind(lib)
        log = _build.BUILD_LOG.get(names[label], "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
        print(f"{label}: registers {min(regs, default=0)}-{max(regs, default=0)} over "
              f"{len(regs)} kernels, spill stores {spills} bytes", flush=True)

    for shape in SHAPES:
        b, n, h, hd, dtype_name = shape
        dtype = getattr(torch, dtype_name)
        variants_ = {what: ka.kernel_variant(dtype, n, hd, what) for what in ka.DIRECTIONS}
        timed = {what: edits_at(libs, v) for what, v in variants_.items() if v in NAMESPACE
                 and args.variant in (None, v)}
        if not timed:
            continue
        gen = torch.Generator("cuda").manual_seed(16)
        q, k, v, do = (torch.randn(b, n, h * hd, device="cuda", generator=gen).to(dtype)
                       for _ in range(4))
        work = torch.empty(ka.stream_work_floats(b, n, h), dtype=torch.float32, device="cuda")
        o, lse = ka.fused_attention_packed_fwd(q, k, v, h, with_lse=True)
        grads = ka.fused_attention_packed_bwd(q, k, v, do, h, o, lse)
        for label in (label for label in EXACT if any(label in t for t in timed.values())):
            got = launch_fwd(libs[label], q, k, v, h)
            again = launch_bwd(libs[label], q, k, v, do, o, lse, h, work)
            if not (torch.equal(got[0], o) and torch.equal(got[1], lse)
                    and all(torch.equal(a, w) for a, w in zip(again, grads))):
                raise RuntimeError(f"{label} is not the kernel bit for bit at {shape}")
        unit, tensor = b * h * n * n * hd, b * n * h * hd * q.element_size()
        for what, flop, nbytes, call in (
                ("fwd", 4 * unit, 4 * tensor, lambda lib: launch_fwd(lib, q, k, v, h)),
                ("bwd", 10 * unit, 7 * tensor,
                 lambda lib: launch_bwd(lib, q, k, v, do, o, lse, h, work))):
            if what not in timed:  # the whole-head forward at N <= 256: no edit changes it
                continue
            best = {}
            for _ in range(3):
                for label in timed[what]:
                    ms = graph_ms(lambda: call(libs[label]), 20)
                    best[label] = min(best.get(label, ms), ms)
            if dtype == torch.float32:
                bound, by = flop / PEAK_F32 * 1e3, "the f32 FMA bound"
            else:
                bound = max(flop / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
                by = "the bf16 bound"
            print(f"attention_diagnose {shape[:4]} {dtype_name} [{variants_[what]}] {what} "
                  f"(device ms, share of {by} {bound:.4f} ms): "
                  + "; ".join(f"{label} {ms:.4f} ({bound / ms:.1%})" for label, ms in best.items())
                  + f" [{card}]", flush=True)

if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

Usage (from the repository root, on a machine with a CUDA card and the CUDA
toolkit):

    python3 chip_smoke.py

Phases — any failure exits non-zero:

  1. build the five hand-written kernels with nvcc (one process per source,
     all started together);
  2. hold each simulator kernel against its plain PyTorch version at the
     main path's shapes (W=4096 rings of capacity 64) — outputs must be
     exactly equal — and time kernel, plain version and library call on the
     device (CUDA graph replay, CUDA events), plus the kernel's eager
     wrapper call; then the same for the attention kernels at the serving
     path's shapes and a few more (ragged, windowed, long, an empty row),
     within a stated bf16 tolerance; then `wkv6` at rwkv6 serving's prefill
     (B=8, S=512, H=32, hd=64) and decode (S=1, carried state) shapes and at
     S=7 and S=1000, from zero and given states, output and final state
     within a stated fp32 tolerance;
  3. run the main path at constellation scale: W=4096 (64x64 mesh), FIB
     n=48 cutoff=28 max_leaf_cost=2048, NEIGHBOR, τ=5, capacity 64, 1500
     ticks — leap/staged (the CUDA default, `deque_apply`), leap/loop
     (`steal_compact`) and tick mode; the two backends must agree field for
     field and tick mode must agree with leap mode except in `events`; a
     300-tick window of both leap runs is timed, then profiled for the
     device's busy share and kernel launches per event;
  4. run drained closed systems at W=100 (FIB n=34 cutoff=18) for all four
     strategies on the card's staged backend (`deque_apply`), and LIFELINE
     once more on the loop backend (`steal_compact`); each run must launch
     its kernel, be exact and equal the port's own CPU run of the same input
     (the CPU runs go in worker processes beside the card runs; every worker
     is joined before the phase ends);
  5. serve qwen2-0.5b at full width (24 layers, d 896, vocab 151936, bf16,
     random weights from seed 0): 8 requests, prompt 512, 64 new tokens
     through `serve_loop.serve_requests` — `flash_attention` must launch 24
     times and `decode_attention` 24 x 63 times; the same inputs then run
     teacher-forced through the plain attention versions and every step's
     logits must agree within a stated tolerance; prefill and decode rates,
     peak device memory and the device's busy share are measured; and
     `simulate_serving` on the launcher's request lengths must give the
     same stats on the card and on the CPU;
  6. serve rwkv6-1.6b at full width (24 layers, d 2048, 32 heads of 64,
     d_ff 7168, vocab 65536, layernorm, bf16, random weights from seed 0):
     8 requests, prompt 512, 64 new tokens through
     `serve_loop.serve_requests` — `wkv6` must launch 24 times in the
     prefill and 24 times in each of the 63 decode steps; the same inputs
     then run teacher-forced through the plain `wkv6` and every step's
     logits must agree within the same tolerance as phase 5; prefill and
     decode rates, peak device memory and the device's busy share are
     measured.

It prints the card's name and power limit, then one JSON line with each
kernel's launches on the main path, error, times and bound, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM non-tensor rate (data sheet), int ops counted here
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate (data sheet)
W_MAIN, CAP_MAIN = 4096, 64
# attention kernels against their plain versions on the card, bf16 outputs:
# |kernel - plain| <= ATOL + RTOL * |plain| elementwise. The values are O(1)
# and reach ~4; the kernels round p to bf16 per block, the plain versions
# after normalising, so outputs may differ by a rounding or two: RTOL is
# about two bf16 ulps of the value (one ulp is 2^-8 to 2^-7 of it), ATOL
# covers values near 0
ATTN_ATOL_BF16, ATTN_RTOL_BF16 = 2e-2, 2 ** -7
# serving: max abs difference of any logit between the kernel path and the
# plain-attention path, teacher-forced on the same tokens (bf16 logits; one
# bf16 ulp at 4 is 2^-5; 24 layers of bf16 rounding in between)
LOGIT_TOL = 0.25
# wkv6 against its plain version on the card, fp32 outputs and states:
# |kernel - plain| <= WKV_RTOL * max|plain| + WKV_ATOL over each compared
# tensor — the same recurrence with its sums in another order (fmaf, four
# partial sums), the error growing with the values the state accumulates
WKV_RTOL, WKV_ATOL = 1e-4, 1e-5


def _bound_ms(nbytes: float, nops: float,
              ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _call_ms(torch, fn, reps: int = 25, inner: int = 40) -> float:
    """Median over `reps` batches of the per-call time of `inner` eager
    back-to-back calls, by CUDA events: what the main path pays per call,
    Python wrapper and launch included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def _device_ms(torch, fn, calls: int = 50, reps: int = 15) -> float:
    """Device time per call: `calls` calls captured in one CUDA graph,
    replayed `reps` times and timed by CUDA events (median), so host launch
    overhead is left out. Inputs stay warm in L2, as on the main path where
    the previous op just wrote them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def _max_abs_err(pairs) -> int:
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in pairs)


def phase_build(build):
    t0 = time.perf_counter()
    build.build()
    print(f"[build] {len(build.SOURCES)} kernels built in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels(torch, np, ops, ref, deque, tasks):
    """Kernels against their plain versions at W=4096, C=64."""
    dev = torch.device("cuda")
    rs = np.random.default_rng(20261016)
    W, C, T = W_MAIN, CAP_MAIN, 4
    G = ref.GRANT_WIDTH
    L = tasks.EXPAND_K + 1

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)

    buf = t(rs.integers(-2**31, 2**31 - 1, (W, C, T), dtype=np.int64))
    # bottoms parked near the wrap for a quarter of the workers
    bot = rs.integers(0, C, W)
    bot[: W // 4] = C - 1 - rs.integers(0, 4, W // 4)
    size = rs.integers(0, C + 1, W)
    size[W // 8: W // 4] = rs.integers(0, 3, W // 8)   # grants > size
    grants = rs.integers(0, G + 1, W)
    bot, size, grants = t(bot), t(size), t(grants)

    out_k = ops.steal_compact(buf, bot, size, grants)
    out_p = ref.steal_compact(buf, bot, size, grants)
    torch.cuda.synchronize()
    err_sc = _max_abs_err(zip(out_k, out_p))
    if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
        raise SystemExit(f"steal_compact disagrees with its plain version "
                         f"(max abs err {err_sc})")
    g = torch.minimum(grants, size).clamp(min=0)
    sc_bytes = (int(g.sum()) * 16 + W * G * 16 + 3 * W * 4 + 2 * W * 4)
    sc_ops = W * G * 8
    def kern():
        return ops.steal_compact(buf, bot, size, grants)

    sc = {
        "ms": _device_ms(torch, kern), "call_ms": _call_ms(torch, kern),
        "plain_ms": _device_ms(torch, lambda: ref.steal_compact(buf, bot, size, grants)),
        "library_ms": None, "max_abs_err": err_sc,
        "bytes": sc_bytes, "ops": sc_ops}
    sc["bound_ms"], sc["bound_by"] = _bound_ms(sc_bytes, sc_ops)

    # push log: slots drawn from a few ring positions so lanes repeat, and
    # live-lane counts n below the lane budget L for most workers
    base = rs.integers(0, C, (W, 1))
    slot = t((base + rs.integers(0, 3, (W, L))) % C)
    rec = t(rs.integers(-2**31, 2**31 - 1, (W, L, T), dtype=np.int64))
    n = t(rs.integers(0, L + 1, W))
    new_k = ops.deque_apply(buf, slot, rec, n)
    new_p = ref.deque_apply(buf, slot, rec, n)
    # the library yardstick: one index_put after the last-lane dedup
    dops = deque.DequeOps(buf0=buf, bot=bot, size=size, slot=slot, rec=rec, n=n)
    last = deque._last_lane_map(dops)
    lanes = torch.arange(L, device=dev)[None, :]
    keep = (lanes < n[:, None]) & (torch.gather(last, 1, slot.long()) == lanes)
    w_idx = torch.arange(W, device=dev)[:, None].expand(W, L)[keep]
    s_idx = slot.long()[keep]
    vals = rec[keep]
    new_l = buf.index_put((w_idx, s_idx), vals)
    torch.cuda.synchronize()
    err_da = _max_abs_err([(new_k, new_p)])
    if not torch.equal(new_k, new_p) or not torch.equal(new_l, new_p):
        raise SystemExit(f"deque_apply disagrees with its plain version "
                         f"(max abs err {err_da})")
    live = int(n.sum())
    da_bytes = 2 * W * C * T * 4 + live * (T * 4 + 4) + W * 4
    da_ops = W * C * (2 * L + 4)
    def kern():
        return ops.deque_apply(buf, slot, rec, n)

    da = {
        "ms": _device_ms(torch, kern), "call_ms": _call_ms(torch, kern),
        "plain_ms": _device_ms(torch, lambda: ref.deque_apply(buf, slot, rec, n)),
        "library_ms": _device_ms(torch, lambda: buf.index_put((w_idx, s_idx), vals)),
        "max_abs_err": err_da, "bytes": da_bytes, "ops": da_ops}
    da["bound_ms"], da["bound_by"] = _bound_ms(da_bytes, da_ops)
    for name, r in (("steal_compact", sc), ("deque_apply", da)):
        print(f"[kernels] {name}: exact; device per launch: kernel "
              f"{r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, library "
              f"{r['library_ms']} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}, {r['bytes']} bytes); eager wrapper call "
              f"{r['call_ms']:.6f} ms")
    return {"steal_compact": sc, "deque_apply": da}


def _flash_work(B, KV, G, S, hd, causal, window, elt):
    """(bytes, FLOPs) prefill attention must move and do: q, k, v read
    once, the output written once; QK and PV products over the visible
    (query, key) pairs only."""
    pairs = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i + 1 if causal else S
        pairs += hi - lo
    nbytes = (2 * B * KV * G * S * hd + 2 * B * KV * S * hd) * elt
    return nbytes, 4 * B * KV * G * pairs * hd


def _decode_work(KV, G, hd, lengths, elt):
    """(bytes, FLOPs) of decode attention: q and output once, the K and V
    rows below each row's length once, the lengths."""
    B, n = len(lengths), int(sum(lengths))
    nbytes = 2 * B * KV * G * hd * elt + 2 * n * KV * hd * elt + 4 * B
    return nbytes, 4 * n * KV * G * hd


def phase_attention(torch, ops, ref):
    """The attention kernels against their plain versions on the card, in
    bf16. The first case of each kernel is the serving path's shape; it is
    also timed (kernel, plain version, eager call, library call)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    bf16, HD = torch.bfloat16, 64

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def check(name, what, got, want, required=True):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        allowed = ATTN_ATOL_BF16 + ATTN_RTOL_BF16 * want.float().abs()
        err, worst = float(diff.max()), float((diff / allowed).max())
        ok = worst <= 1 and bool(torch.isfinite(got.float()).all())
        print(f"[kernels] {name} {what}: max abs err {err:.6f}, max err / "
              f"allowed {worst:.4f} (allowed {ATTN_ATOL_BF16} + {ATTN_RTOL_BF16} "
              f"x |plain|{'' if required else '; not required'})")
        if required and not ok:
            raise SystemExit(f"{name} {what} disagrees with its plain version")
        return err

    out = {}
    # flash attention: (B, S, G, causal, window); the first is the path's
    flash_cases = [(8, 512, 7, True, 0), (1, 2048, 7, True, 0),
                   (2, 500, 7, True, 0), (2, 500, 7, True, 128),
                   (1, 333, 7, False, 0)]
    errs = []
    for i, (B, S, G, causal, window) in enumerate(flash_cases):
        q, k, v = rnd(B, 2, G, S, HD), rnd(B, 2, S, HD), rnd(B, 2, S, HD)
        errs.append(check("flash_attention",
                          f"B={B} KV=2 G={G} S={S} causal={causal} window={window}",
                          ops.flash_attention(q, k, v, causal=causal, window=window),
                          ref.flash_attention(q, k, v, causal=causal, window=window)))
        if i == 0:
            nbytes, nops = _flash_work(B, 2, G, S, HD, causal, window, 2)
            qh = q.view(B, 2 * G, S, HD)
            r = {"ms": _device_ms(torch, lambda: ops.flash_attention(q, k, v)),
                 "call_ms": _call_ms(torch, lambda: ops.flash_attention(q, k, v)),
                 "plain_ms": _device_ms(torch, lambda: ref.flash_attention(q, k, v)),
                 "library_ms": _device_ms(torch, lambda: F.scaled_dot_product_attention(
                     qh, k, v, is_causal=True, enable_gqa=True)),
                 "bytes": nbytes, "ops": nops}
            r["bound_ms"], r["bound_by"] = _bound_ms(nbytes, nops, BF16_OPS_PER_S)
            lib = F.scaled_dot_product_attention(qh, k, v, is_causal=True,
                                                 enable_gqa=True)
            check("flash_attention", "library call (SDPA) vs plain",
                  lib.view_as(q), ref.flash_attention(q, k, v), required=False)
            out["flash_attention"] = r
    out["flash_attention"]["max_abs_err"] = max(errs)

    # decode attention: (B, T, lengths); the first is the path's (ragged,
    # 512..575 written positions of a 584-slot cache)
    g2 = torch.Generator().manual_seed(7)
    decode_cases = [(8, 584, torch.randint(512, 576, (8,), generator=g2).tolist()),
                    (4, 4096, [0, 4096, 1, 2500]), (3, 100, [64, 65, 100])]
    errs = []
    for i, (B, T, lengths) in enumerate(decode_cases):
        q, kc, vc = rnd(B, 2, 7, HD), rnd(B, 2, T, HD), rnd(B, 2, T, HD)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = ops.decode_attention(q, kc, vc, ln)
        errs.append(check("decode_attention", f"B={B} KV=2 G=7 T={T} lengths={lengths}",
                          got, ref.decode_attention(q, kc, vc, ln)))
        if 0 in lengths and not bool((got[lengths.index(0)] == 0).all()):
            raise SystemExit("decode_attention: a row of length 0 is not 0")
        if i == 0:
            nbytes, nops = _decode_work(2, 7, HD, lengths, 2)
            mask = (torch.arange(T, device=dev)[None, :] < ln[:, None])[:, None, None, :]
            qh = q.view(B, 14, 1, HD)
            r = {"ms": _device_ms(torch, lambda: ops.decode_attention(q, kc, vc, ln)),
                 "call_ms": _call_ms(torch, lambda: ops.decode_attention(q, kc, vc, ln)),
                 "plain_ms": _device_ms(torch, lambda: ref.decode_attention(q, kc, vc, ln)),
                 "library_ms": _device_ms(torch, lambda: F.scaled_dot_product_attention(
                     qh, kc, vc, attn_mask=mask, enable_gqa=True)),
                 "bytes": nbytes, "ops": nops}
            r["bound_ms"], r["bound_by"] = _bound_ms(nbytes, nops, BF16_OPS_PER_S)
            lib = F.scaled_dot_product_attention(qh, kc, vc, attn_mask=mask,
                                                 enable_gqa=True)
            check("decode_attention", "library call (SDPA) vs plain",
                  lib.view_as(q), ref.decode_attention(q, kc, vc, ln), required=False)
            out["decode_attention"] = r
    out["decode_attention"]["max_abs_err"] = max(errs)
    for name, r in out.items():
        print(f"[kernels] {name}: device per launch at the serving shape: kernel "
              f"{r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, library "
              f"{r['library_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}; {r['bytes']} bytes, {r['ops']} FLOP); eager "
              f"wrapper call {r['call_ms']:.6f} ms")
    return out


def _wkv6_work(B, S, H, hd, state: bool):
    """(bytes, FLOPs) of the WKV6 recurrence: r, k, v, w and u read once,
    the output written once, the given state read once and the final state
    written once; per step and (b, h), 5·hd² FLOPs for the r·S product and
    the rank-1 state update, plus 4·hd for the u bonus term."""
    n = B * S * H * hd
    st = B * H * hd * hd * 4
    nbytes = 5 * n * 4 + H * hd * 4 + st * (2 if state else 1)
    return nbytes, B * S * H * (5 * hd * hd + 4 * hd)


def _wkv6_inputs(torch, gen, B, S, H, hd, state):
    """r, k, v, w, u and a state as rwkv6's time mix makes them: r, k, v
    from bf16 matmuls of unit-scale activations with normal(0, 0.02)
    weights, cast to fp32; w = exp(-exp(w0 + lora)) with w0 per channel in
    (-6, -0.5) (slow to fast decay) and the LoRA of two bf16 matmuls; u ~
    N(0, 0.3^2). `state` is None (none given: the kernel starts from
    zeros), "zeros" (a zero tensor, what prefill passes) or "random" (~
    N(0, 0.3^2), a state carried into decode)."""
    dev = torch.device("cuda")
    D = H * hd
    bf16 = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = rnd(B, S, D).to(bf16)
    r, k, v = ((x @ rnd(D, D, scale=0.02).to(bf16)).float().view(B, S, H, hd)
               for _ in range(3))
    w0 = torch.rand((D,), generator=gen, device=dev) * 5.5 - 6.0
    lora = (x @ rnd(D, 64, scale=0.02).to(bf16)) @ rnd(64, D, scale=0.02).to(bf16)
    w = torch.exp(-torch.exp(w0 + lora.float())).view(B, S, H, hd)
    u = rnd(H, hd, scale=0.3)
    if state is None:
        return r, k, v, w, u, None
    if state == "zeros":
        return r, k, v, w, u, torch.zeros((B, H, hd, hd), device=dev)
    return r, k, v, w, u, rnd(B, H, hd, hd, scale=0.3)


def phase_wkv6(torch, ops, ref):
    """`wkv6` against its plain version on the card, in fp32. The first
    case is rwkv6 serving's prefill (a zero state tensor given), the second
    its decode (a carried state); both are timed (kernel, plain version,
    eager call)."""
    gen = torch.Generator(device=torch.device("cuda"))
    gen.manual_seed(20261018)
    cases = [(8, 512, 32, "zeros"), (8, 1, 32, "random"), (8, 512, 32, "random"),
             (8, 512, 32, None), (2, 7, 32, None), (2, 1000, 4, "random"),
             (3, 1, 4, None)]
    errs, timed = [], {}
    for i, (B, S, H, state) in enumerate(cases):
        r, k, v, w, u, s0 = _wkv6_inputs(torch, gen, B, S, H, 64, state)
        got = ops.wkv6(r, k, v, w, u, s0)
        want = ref.wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        for what, g, p in (("out", got[0], want[0]), ("final state", got[1], want[1])):
            err = float((g - p).abs().max())
            allowed = WKV_RTOL * float(p.abs().max()) + WKV_ATOL
            errs.append(err)
            print(f"[kernels] wkv6 B={B} S={S} H={H} hd=64 state "
                  f"{state or 'none'}, {what}: max abs err "
                  f"{err:.3e}, max |plain| {float(p.abs().max()):.4f}, allowed "
                  f"{allowed:.3e} ({WKV_RTOL} x max|plain| + {WKV_ATOL})")
            if not err <= allowed or not bool(torch.isfinite(g).all()):
                raise SystemExit(f"wkv6 B={B} S={S} {what} disagrees with its "
                                 f"plain version")
        if i < 2:
            nbytes, nops = _wkv6_work(B, S, H, 64, s0 is not None)

            def kern():
                return ops.wkv6(r, k, v, w, u, s0)

            def plain():
                return ref.wkv6(r, k, v, w, u, s0)

            t = {"ms": _device_ms(torch, kern), "call_ms": _call_ms(torch, kern),
                 # the plain version launches ~10 kernels a step: few calls a graph
                 "plain_ms": _device_ms(torch, plain, calls=2, reps=5),
                 "library_ms": None, "bytes": nbytes, "ops": nops}
            t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, nops)
            timed["prefill" if i == 0 else "decode"] = t
            print(f"[kernels] wkv6 at the serving {'prefill' if i == 0 else 'decode'} "
                  f"shape B={B} S={S} H={H}: kernel {t['ms']:.6f} ms, plain "
                  f"{t['plain_ms']:.6f} ms, library none (no single PyTorch call), "
                  f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}; {nbytes} bytes, "
                  f"{nops} FLOP); eager wrapper call {t['call_ms']:.6f} ms")
    out = dict(timed["prefill"])
    out["max_abs_err"] = max(errs)
    out["decode_ms"] = timed["decode"]["ms"]
    out["decode_plain_ms"] = timed["decode"]["plain_ms"]
    out["decode_bound_ms"] = timed["decode"]["bound_ms"]
    return {"wkv6": out}


def _assert_equal(np, a, b, skip=(), what=""):
    for f in a._fields:
        if f in skip:
            continue
        x, y = getattr(a, f), getattr(b, f)
        same = (np.array_equal(np.asarray(x), np.asarray(y))
                if isinstance(x, np.ndarray) or isinstance(y, np.ndarray)
                else x == y)
        if not same:
            raise SystemExit(f"{what}: field {f} differs: {x!r} vs {y!r}")


def _profile(torch, fn):
    """Run `fn` under torch.profiler (CUDA activity); returns (device busy
    ms, device activities, {name: (device ms, count)}). Busy time is the sum
    of the device activities' durations (one stream: they never overlap).
    Reads the raw kineto events: building the profiler's per-op tables for
    ~10^5 kernels costs minutes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms, cnt = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, cnt + 1)
    busy = sum(ms for ms, _ in by_name.values())
    return busy, sum(c for _, c in by_name.values()), by_name


def phase_main_path(torch, np, sim, topo, tasks, ops):
    """W=4096 Starlink-scale closed run on the card, both deque backends."""
    mesh = topo.MeshTopology.square(W_MAIN)
    wl = tasks.FibWorkload(n=48, cutoff=28, max_leaf_cost=2048)
    base = dict(strategy=sim.stealing.Strategy.NEIGHBOR, hop_ticks=5,
                capacity=CAP_MAIN, max_ticks=1500)
    runs, launches, profiled = {}, {}, {}
    for label, extra, kernel in (
            ("leap/staged", {}, "deque_apply"),
            ("leap/loop", {"deque_backend": "loop"}, "steal_compact"),
            ("tick/staged", {"step_mode": "tick"}, "deque_apply")):
        cfg = sim.SimConfig(**base, **extra)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = sim.simulate(wl, mesh, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        if counts[kernel] == 0:
            raise SystemExit(f"{label}: kernel {kernel} was never launched")
        runs[label] = r
        launches.setdefault(kernel, counts[kernel])
        print(f"[main] W={W_MAIN} {label}: ticks={r.ticks} events={r.events} "
              f"wall={dt:.3f} s ticks/s={r.ticks / dt:.2f} "
              f"events/s={r.events / dt:.2f} ms/event={dt / r.events * 1e3:.3f} "
              f"nodes={r.nodes} overflow={r.overflow} "
              f"hiwater={int(r.per_worker_hiwater.max())} launches={counts}")
    _assert_equal(np, runs["leap/staged"], runs["leap/loop"],
                  what="staged vs loop")
    _assert_equal(np, runs["leap/staged"], runs["tick/staged"],
                  skip=("events",), what="leap vs tick")
    r = runs["leap/staged"]
    if r.ticks != base["max_ticks"] or r.nodes <= 0 or r.overflow != 0:
        raise SystemExit(f"main path: unexpected result {r.ticks=} "
                         f"{r.nodes=} {r.overflow=}")
    print("[main] staged == loop field for field; tick == leap except events")
    # where the time goes: a 300-tick window of each leap run, timed
    # unprofiled, then again under the profiler
    for label, extra, kernel in (
            ("leap/staged", {}, "deque_apply"),
            ("leap/loop", {"deque_backend": "loop"}, "steal_compact")):
        cfg = sim.SimConfig(**{**base, "max_ticks": 300}, **extra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = sim.simulate(wl, mesh, cfg).events
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy, n_dev, by_name = _profile(torch, lambda: sim.simulate(wl, mesh, cfg))
        hits = [v for k, v in by_name.items() if f"{kernel}_kernel" in k]
        k_ms, k_n = sum(ms for ms, _ in hits), sum(c for _, c in hits)
        if k_n == 0:
            raise SystemExit(f"profile of {label}: no {kernel} kernel seen")
        profiled[kernel] = k_ms / k_n
        print(f"[profile] W={W_MAIN} {label}, 300 ticks, {ev} events: device "
              f"busy {busy:.3f} ms of {wall_ms:.3f} ms wall (busy share "
              f"{busy / wall_ms:.4f}); {n_dev} device activities = "
              f"{n_dev / ev:.1f} per event; {kernel} {k_n}x, "
              f"{k_ms / k_n * 1e3:.3f} us each")
        for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
            print(f"[profile]   {ms:9.3f} ms {cnt:7d}x {name[:90]}")
    return launches, profiled


def _drained_cpu_run(strategy_value: str):
    """The port's CPU run of one drained W=100 configuration (runs in a
    worker process, beside the card runs of the main process)."""
    import torch

    from repro_torch.core import simulator as sim
    from repro_torch.core import tasks
    from repro_torch.core import topology as topo

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    r = sim.simulate(tasks.FibWorkload(n=34, cutoff=18),
                     topo.MeshTopology.square(100), _drained_cfg(sim, strategy_value),
                     device="cpu")
    return r, time.perf_counter() - t0


def _drained_cfg(sim, strategy_value: str, **extra):
    return sim.SimConfig(strategy=sim.stealing.Strategy(strategy_value),
                         hop_ticks=5, capacity=64, **extra)


def phase_drained(torch, np, sim, topo, tasks, ops):
    """Drained W=100 runs of every strategy on the card (staged backend,
    `deque_apply`), plus one on the loop backend (`steal_compact`); each
    exact, each launching its kernel, and equal to the port's CPU run of
    the same input."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    mesh = topo.MeshTopology.square(100)
    wl = tasks.FibWorkload(n=34, cutoff=18)
    strategies = [s.value for s in sim.stealing.Strategy]
    card_runs = [(v, "staged", "deque_apply") for v in strategies]
    card_runs.append(("lifeline", "loop", "steal_compact"))
    with ProcessPoolExecutor(len(strategies),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_runs = {v: pool.submit(_drained_cpu_run, v) for v in strategies}
        for v, backend, kernel in card_runs:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rg = sim.simulate(wl, mesh, _drained_cfg(sim, v, deque_backend=backend))
            torch.cuda.synchronize()
            dt_g = time.perf_counter() - t0
            counts = dict(ops.LAUNCHES)
            what = f"W=100 {v} {backend}"
            if counts[kernel] == 0:
                raise SystemExit(f"{what}: kernel {kernel} was never launched")
            if (rg.result != wl.expected_result()
                    or rg.nodes != wl.expected_nodes() or rg.overflow != 0):
                raise SystemExit(f"{what}: result {rg.result} nodes "
                                 f"{rg.nodes} overflow {rg.overflow} not exact")
            rc, dt_c = cpu_runs[v].result()
            _assert_equal(np, rg, rc, what=f"{what} card vs cpu")
            print(f"[drained] {what}: exact (result={rg.result} "
                  f"nodes={rg.nodes}), ticks={rg.ticks} events={rg.events}, "
                  f"card {dt_g:.3f} s ({dt_g / rg.events * 1e3:.3f} ms/event), "
                  f"launches={counts}, cpu {dt_c:.3f} s in a worker process, "
                  f"card == cpu")


SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 512, 64


def _greedy_run(torch, model, cfg, params, prompts, cache_len, feed=None):
    """Prefill `prompts`, then SERVE_NEW - 1 decode steps of `model` (a
    module or `ModelFns` with `prefill` and `decode_step`). Step i is fed `feed[:, i]`,
    or the greedy token of the step before when `feed` is None. Returns
    (greedy tokens (B, SERVE_NEW), logits (SERVE_NEW, B, V))."""
    logits, cache, pos = model.prefill(params, cfg, prompts, cache_len)
    steps = [logits]
    for i in range(SERVE_NEW - 1):
        tok = steps[-1].argmax(-1) if feed is None else feed[:, i]
        logits, cache, pos = model.decode_step(params, cfg, tok.long(), cache, pos)
        steps.append(logits)
    logits = torch.stack(steps)
    return logits.argmax(-1).t().to(torch.int32), logits


def _served_view(torch, greedy, eos: int):
    """What `serve_requests` returns for a greedy token sequence: the first
    token as is, later ones replaced by EOS from the first EOS on."""
    later = greedy[:, 1:]
    alive = torch.cumprod((later != eos).int(), dim=1).bool()
    return torch.cat([greedy[:, :1], torch.where(alive, later, eos)], dim=1)


def phase_serve(torch, np, ops, ref):
    """qwen2-0.5b at full width on the card through the serving entry
    point; kernel path against the plain attention path; rates, memory,
    busy share; the serving simulation card == CPU."""
    from unittest import mock

    from repro_torch.models import registry, transformer
    from repro_torch.runtime import serve_loop

    cfg = registry.get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} kv, hd {cfg.hd}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; {n_params} parameters (config count "
          f"{cfg.n_params()}), random from seed 0, made in "
          f"{time.perf_counter() - t0:.3f} s")
    sc = serve_loop.ServeConfig(max_new_tokens=SERVE_NEW, prompt_len=SERVE_PROMPT,
                                cache_len=SERVE_PROMPT + SERVE_NEW + 8)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device="cuda")
    # warm-up: cuBLAS handles, the kernels' libraries, the allocator
    serve_loop.serve_requests(cfg, params, serve_loop.ServeConfig(
        max_new_tokens=2, prompt_len=SERVE_PROMPT, cache_len=sc.cache_len),
        prompts)
    torch.cuda.synchronize()

    # the main path: launches counted from 0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    served, info = serve_loop.serve_requests(cfg, params, sc, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * (SERVE_NEW - 1)}
    print(f"[serve] serve_requests: {info['decoded']} tokens in {wall:.3f} s "
          f"({info['decoded'] / wall:.2f} tokens/s end to end); launches "
          f"{counts}; peak device memory {peak} bytes")
    for name, n in want.items():
        if counts[name] != n:
            raise SystemExit(f"serve: {name} launched {counts[name]} times, "
                             f"expected {n}")
    if tuple(served.shape) != (SERVE_BATCH, SERVE_NEW):
        raise SystemExit(f"serve: output shape {tuple(served.shape)}")

    # kernel path, greedy, and the plain attention path teacher-forced on
    # its tokens: every step's logits compared
    greedy_k, logits_k = _greedy_run(torch, transformer, cfg, params, prompts,
                                     sc.cache_len)
    reproduced = bool(torch.equal(_served_view(torch, greedy_k, sc.eos_id), served))
    with mock.patch.object(ops, "flash_attention", ref.flash_attention), \
            mock.patch.object(ops, "decode_attention", ref.decode_attention):
        greedy_p, logits_p = _greedy_run(torch, transformer, cfg, params, prompts,
                                         sc.cache_len, feed=greedy_k)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits_k.float()).all()):
        raise SystemExit("serve: non-finite logits on the kernel path")
    diff = (logits_k.float() - logits_p.float()).abs()
    step_err = diff.amax(dim=(1, 2)).tolist()
    agree = float((greedy_k == greedy_p).float().mean())
    print(f"[serve] kernel vs plain attention, teacher-forced: max abs logit "
          f"difference prefill {step_err[0]:.6f}, decode steps max "
          f"{max(step_err[1:]):.6f} (tolerance {LOGIT_TOL}); mean abs "
          f"{float(diff.mean()):.6f}; |logit| max {float(logits_k.abs().max()):.4f}; "
          f"greedy-token agreement {agree:.6f} over {greedy_k.numel()} tokens; "
          f"the kernel rerun reproduces the served tokens: {reproduced}")
    if max(step_err) > LOGIT_TOL:
        raise SystemExit("serve: kernel path and plain attention path disagree")
    del logits_k, logits_p, diff

    # rates: prefill, and decode steps fed the greedy tokens
    def prefill():
        return transformer.prefill(params, cfg, prompts, sc.cache_len)

    def decode(cache, pos, n=SERVE_NEW - 1):
        for i in range(n):
            transformer.decode_step(params, cfg, greedy_k[:, i].long(), cache, pos + i)

    pre_s, dec_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache, pos = prefill()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode(cache, pos)
        torch.cuda.synchronize()
        pre_s.append(t1 - t0)
        dec_s.append((time.perf_counter() - t1) / (SERVE_NEW - 1))
    pre, dec = sorted(pre_s)[1], sorted(dec_s)[1]
    print(f"[serve] prefill {SERVE_BATCH}x{SERVE_PROMPT}: {pre * 1e3:.3f} ms "
          f"({SERVE_BATCH * SERVE_PROMPT / pre:.2f} tokens/s); decode "
          f"{dec * 1e3:.3f} ms/step ({SERVE_BATCH / dec:.2f} tokens/s) at batch "
          f"{SERVE_BATCH}, cache {sc.cache_len} (median of 3)")

    # where the time goes: one prefill and 16 decode steps under the profiler
    profiled = {}
    n_prof = min(16, SERVE_NEW - 1)
    for what, fn, kernel in (
            ("prefill", prefill, ("flash_attention_kernel",)),
            (f"decode x{n_prof}", lambda: decode(cache, pos, n_prof),
             ("decode_partial_kernel", "decode_combine_kernel"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy, n_dev, by_name = _profile(torch, fn)
        hits = [(k, v) for k, v in by_name.items() if any(n in k for n in kernel)]
        k_ms = sum(ms for _, (ms, _) in hits)
        k_n = max(c for k, (_, c) in hits if kernel[0] in k) if hits else 0
        if k_n == 0:
            raise SystemExit(f"profile of {what}: no {kernel[0]} seen")
        name = "flash_attention" if what == "prefill" else "decode_attention"
        profiled[name] = k_ms / k_n
        print(f"[profile] serve {what}: device busy {busy:.3f} ms of {wall_ms:.3f} "
              f"ms wall (busy share {busy / wall_ms:.4f}); {n_dev} device "
              f"activities; {name} {k_n}x, {k_ms / k_n * 1e3:.3f} us each, "
              f"{k_ms / busy:.4f} of the busy time")
        for kname, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"[profile]   {ms:9.3f} ms {cnt:7d}x {kname[:90]}")

    # the serving simulation: card == CPU on the launcher's request lengths
    rng = np.random.default_rng(0)
    lens = np.minimum((rng.pareto(1.2, (4, 8 * 4)) * 16 + 4), 64).astype(np.int32)
    sim_cfg = serve_loop.ServeConfig(batch_slots=8, n_shards=4)
    t0 = time.perf_counter()
    on_card = serve_loop.simulate_serving(cfg, sim_cfg, lens)
    t_card = time.perf_counter() - t0
    on_cpu = serve_loop.simulate_serving(cfg, sim_cfg, lens, device="cpu")
    if on_card != on_cpu:
        raise SystemExit(f"simulate_serving: card {on_card} != cpu {on_cpu}")
    print(f"[serve] simulate_serving card == cpu: occupancy "
          f"{on_card.occupancy:.6f} moved={on_card.moved} steps={on_card.steps} "
          f"completed={on_card.completed} (card {t_card:.3f} s)")
    return counts, profiled


def phase_serve_rwkv6(torch, np, ops, ref):
    """rwkv6-1.6b at full width on the card through the serving entry
    point; kernel path against the plain `wkv6` path; rates, memory, busy
    share. Returns (main-path launches, per-launch device ms of `wkv6` in
    the profiled prefill and decode)."""
    from unittest import mock

    from repro_torch.models import registry
    from repro_torch.runtime import serve_loop

    cfg = registry.get_config("rwkv6-1.6b")
    fns = registry.get_fns(cfg)
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = fns.init(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve_rwkv6] {cfg.name}: {L} layers, d {cfg.d_model}, "
          f"{cfg.d_model // cfg.rwkv_head_dim} heads of {cfg.rwkv_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.norm}, {cfg.dtype}; {n_params} "
          f"parameters in the tree (config count {cfg.n_params()}: it counts the "
          f"channel mix as 3·D·d_ff, the tree holds 2·D·d_ff + D²), random from "
          f"seed 0, made in {time.perf_counter() - t0:.3f} s")
    sc = serve_loop.ServeConfig(max_new_tokens=SERVE_NEW, prompt_len=SERVE_PROMPT,
                                cache_len=SERVE_PROMPT + SERVE_NEW + 8)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device="cuda")
    # warm-up: cuBLAS handles, the kernel's library, the allocator
    serve_loop.serve_requests(cfg, params, serve_loop.ServeConfig(
        max_new_tokens=2, prompt_len=SERVE_PROMPT, cache_len=sc.cache_len),
        prompts)
    torch.cuda.synchronize()

    # the main path: launches counted from 0
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    served, info = serve_loop.serve_requests(cfg, params, sc, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve_rwkv6] serve_requests: {info['decoded']} tokens in {wall:.3f} s "
          f"({info['decoded'] / wall:.2f} tokens/s end to end); launches "
          f"{counts}; peak device memory {peak} bytes ({before} allocated "
          f"before the run, the weights and what earlier phases hold)")
    if counts["wkv6"] != L * SERVE_NEW:
        raise SystemExit(f"serve_rwkv6: wkv6 launched {counts['wkv6']} times, "
                         f"expected {L} + {L} x {SERVE_NEW - 1}")
    if tuple(served.shape) != (SERVE_BATCH, SERVE_NEW):
        raise SystemExit(f"serve_rwkv6: output shape {tuple(served.shape)}")

    # kernel path, greedy, and the plain wkv6 path teacher-forced on its
    # tokens: every step's logits compared
    greedy_k, logits_k = _greedy_run(torch, fns, cfg, params, prompts,
                                     sc.cache_len)
    reproduced = bool(torch.equal(_served_view(torch, greedy_k, sc.eos_id), served))
    with mock.patch.object(ops, "wkv6", ref.wkv6):
        greedy_p, logits_p = _greedy_run(torch, fns, cfg, params, prompts,
                                         sc.cache_len, feed=greedy_k)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits_k.float()).all()):
        raise SystemExit("serve_rwkv6: non-finite logits on the kernel path")
    diff = (logits_k.float() - logits_p.float()).abs()
    step_err = diff.amax(dim=(1, 2)).tolist()
    agree = float((greedy_k == greedy_p).float().mean())
    print(f"[serve_rwkv6] kernel vs plain wkv6, teacher-forced: max abs logit "
          f"difference prefill {step_err[0]:.6f}, decode steps max "
          f"{max(step_err[1:]):.6f} (tolerance {LOGIT_TOL}); mean abs "
          f"{float(diff.mean()):.6f}; |logit| max {float(logits_k.abs().max()):.4f}; "
          f"greedy-token agreement {agree:.6f} over {greedy_k.numel()} tokens; "
          f"the kernel rerun reproduces the served tokens: {reproduced}")
    if max(step_err) > LOGIT_TOL:
        raise SystemExit("serve_rwkv6: kernel path and plain wkv6 path disagree")
    del logits_k, logits_p, diff

    # rates: prefill, and decode steps fed the greedy tokens; the launches
    # of each half are asserted on its own
    def prefill():
        return fns.prefill(params, cfg, prompts, sc.cache_len)

    def decode(state, pos, n=SERVE_NEW - 1):
        for i in range(n):
            _, state, pos = fns.decode_step(params, cfg, greedy_k[:, i].long(),
                                            state, pos)

    pre_s, dec_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, state, pos = prefill()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_pre = ops.LAUNCHES["wkv6"]
        decode(state, pos)
        torch.cuda.synchronize()
        n_dec = ops.LAUNCHES["wkv6"] - n_pre
        if (n_pre, n_dec) != (L, L * (SERVE_NEW - 1)):
            raise SystemExit(f"serve_rwkv6: wkv6 launched {n_pre} times in the "
                             f"prefill and {n_dec} in the decode steps")
        pre_s.append(t1 - t0)
        dec_s.append((time.perf_counter() - t1) / (SERVE_NEW - 1))
    pre, dec = sorted(pre_s)[1], sorted(dec_s)[1]
    print(f"[serve_rwkv6] wkv6 launches: {L} in the prefill, {L} x "
          f"{SERVE_NEW - 1} in the decode steps; prefill {SERVE_BATCH}x"
          f"{SERVE_PROMPT}: {pre * 1e3:.3f} ms ({SERVE_BATCH * SERVE_PROMPT / pre:.2f} "
          f"tokens/s); decode {dec * 1e3:.3f} ms/step ({SERVE_BATCH / dec:.2f} "
          f"tokens/s) at batch {SERVE_BATCH} (median of 3)")

    # where the time goes: one prefill and 16 decode steps under the profiler
    profiled = {}
    n_prof = min(16, SERVE_NEW - 1)
    for what, fn in (("prefill", prefill),
                     (f"decode x{n_prof}", lambda: decode(state, pos, n_prof))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy, n_dev, by_name = _profile(torch, fn)
        hits = [v for k, v in by_name.items() if "wkv6_kernel" in k]
        k_ms, k_n = sum(ms for ms, _ in hits), sum(c for _, c in hits)
        if k_n == 0:
            raise SystemExit(f"profile of {what}: no wkv6_kernel seen")
        profiled[what.split()[0]] = k_ms / k_n
        print(f"[profile] serve_rwkv6 {what}: device busy {busy:.3f} ms of "
              f"{wall_ms:.3f} ms wall (busy share {busy / wall_ms:.4f}); {n_dev} "
              f"device activities; wkv6 {k_n}x, {k_ms / k_n * 1e3:.3f} us each, "
              f"{k_ms / busy:.4f} of the busy time")
        for kname, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"[profile]   {ms:9.3f} ms {cnt:7d}x {kname[:90]}")
    return counts, profiled


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core import deque, tasks
    from repro_torch.core import simulator as sim
    from repro_torch.core import topology as topo
    from repro_torch.kernels import build, ops, ref

    t_start = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    phase_build(build)
    kern = phase_kernels(torch, np, ops, ref, deque, tasks)
    kern.update(phase_attention(torch, ops, ref))
    kern.update(phase_wkv6(torch, ops, ref))
    launches, profiled = phase_main_path(torch, np, sim, topo, tasks, ops)
    phase_drained(torch, np, sim, topo, tasks, ops)
    serve_counts, serve_profiled = phase_serve(torch, np, ops, ref)
    launches.update({k: serve_counts[k] for k in serve_profiled})
    profiled.update(serve_profiled)
    rwkv_counts, rwkv_profiled = phase_serve_rwkv6(torch, np, ops, ref)
    launches["wkv6"] = rwkv_counts["wkv6"]
    profiled["wkv6"] = rwkv_profiled["prefill"]
    kern["wkv6"]["main_path_decode_device_ms"] = rwkv_profiled["decode"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[total] {time.perf_counter() - t_start:.3f} s")
    print(smi)
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name]["library_ms"],
         "call_ms": kern[name]["call_ms"],
         "main_path_device_ms": profiled[name],
         **{k: v for k, v in kern[name].items() if k.startswith(("decode_", "main_"))}}
        for name, replaces in (
            ("steal_compact", "src/repro/kernels/steal_compact.py:44"),
            ("deque_apply", "src/repro/kernels/deque_apply.py:42"),
            ("flash_attention", "src/repro/kernels/flash_attention.py:79"),
            ("decode_attention", "src/repro/kernels/decode_attention.py:63"),
            ("wkv6", "src/repro/kernels/rwkv6_scan.py:57"))]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

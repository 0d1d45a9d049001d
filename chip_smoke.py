#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

Usage (from the repository root, on a machine with a CUDA card and the CUDA
toolkit):

    python3 chip_smoke.py

Phases — any failure exits non-zero:

  1. build the six hand-written kernels with nvcc (one process per source,
     all started together), print their `ptxas -v` lines and count the
     tensor-core instructions in the machine code of the attention kernels'
     bf16 instantiations: HGMMA (wgmma) in `flash_attention`'s, HMMA
     (mma.sync) in `decode_attention`'s;
  2. hold each simulator kernel against its plain PyTorch version at the
     main path's shapes (W=4096 rings of capacity 64) and at the sweep's
     (18 x 4096 = 73,728 rings) — outputs must be exactly equal: the
     in-place `deque_apply` run on copies of the rings, with repeated and
     out-of-range slots, rows with n = 0 and rows gated off by
     `deque.apply`'s `keep` coming back bit for bit; `steal_compact` at
     export widths 8 and 4, grants above the width — and time kernel, plain
     version and library call (for `deque_apply` an in-place `index_put_`
     of the same winners) on the
     device (CUDA graph replay, CUDA events), plus the kernel's eager
     wrapper call, beside the launch floor (a one-element elementwise op in
     the same harness); then the same for the attention kernels at the serving
     paths' shapes — head dim 64 with 7 query heads per KV head (qwen2) and
     head dim 256 with 16 over one (recurrentgemma: prefill S=2560 with a
     2048-token window, decode against a full 2048-slot ring) — and a few
     more (ragged, windowed, long, an empty row, shorter than a key tile,
     window 1, one past a row tile, scores spread by q x 8; decode lengths
     at the edges of a tile, a chunk and a cluster of the bf16 decode
     kernel, and a repeated call after the timing runs, bit-equal to the
     first), within a stated bf16 tolerance, with SDPA as the library
     yardstick; then `wkv6` at rwkv6
     serving's prefill (B=8, S=512, H=32, hd=64) and decode (S=1, carried
     state) shapes with bf16 r, k, v as the time mix hands them over and
     with fp32 ones, at S=7, one past the sequence kernel's tile and 1000,
     from zero and given states, output and final state within a stated
     fp32 tolerance, and a repeated call bit-equal to the first; at the
     decode shape also the sequence kernel (a build without the step
     kernel, WKV6_STEP_KERNEL=0) in turns with the step kernel, the
     measurement behind the launch's choice by S; then `rglru` at
     recurrentgemma serving's prefill (B=8, S=2560, W=4096, bf16, zero state)
     and decode (S=1, carried state) shapes, bit-equal to the plain version,
     then a ragged S, a long one, fp32 inputs, S at the edges of the
     sequence kernel's TMA ring and W not a multiple of its block, output
     and final state within a stated fp32 tolerance;
  3. run the main path at constellation scale: W=4096 (64x64 mesh), FIB
     n=48 cutoff=28 max_leaf_cost=2048, NEIGHBOR, τ=5, capacity 64, 1500
     ticks, each loop iteration a replay of a captured CUDA graph —
     leap mode with the famine fast path at its default batch of 64 on the
     loop backend (the default, `steal_compact`) and on the staged backend
     (`deque_apply`), the same two with the fast path off (famine_batch
     0), and tick mode (staged); every run must agree field for field
     except in `events`, and `events` must equal the reference's (287 at
     64, 667 at 0); a 300-tick window of each run is timed, then profiled
     for the device's busy share and activities per event;
  4. run drained closed systems at W=100 (FIB n=34 cutoff=18, the default
     famine batch) for all four strategies on the staged backend
     (`deque_apply`), and LIFELINE once more on the loop backend
     (`steal_compact`); each run must launch its kernel, be exact and equal
     the port's own CPU run of the same input, `events` included (the CPU
     runs go in worker processes beside the card runs; every worker is
     joined before the phase ends);
  5. run the crossover's axes over the main path's configuration as one
     grid: strategy {neighbor, global} x tau {2, 5, 10} x seed {0, 1, 2}, 18
     points (73,728 workers) in one `simulate_sweep` — one core call, one
     captured graph; every point must equal the port's own `simulate` of it
     on the card, `events` included, and the (neighbor, 5, 0) point the
     main path's run; the grid's wall against the 18 runs', a profiled
     300-tick window of the grid, and a staged-backend sweep of the 6
     seed-0 points (`deque_apply` at 24,576 rows) equal to the loop sweep;
  6. run the port's crossover benchmark (`repro_torch.benchmarks.sweep`) at
     BENCH_crossover.json's settings, one grid a size, with the flight
     recorder's RTT rows (one traced grid of both strategies at N=64, tau
     5); every point's ticks must equal the reference's, pinned in
     CROSSOVER_TICKS, and every RTT row's resolved attempts, grants and mean
     round trip the reference's, pinned in RTT_PINS (NEIGHBOR's exactly
     2·tau); the document goes to chiprun_out/BENCH_crossover_torch.json;
  7. run the fault model (`phase_faults`) at the main path's configuration
     (W=4096, 1500 ticks) under schedules made with numpy from seed 0 after
     examples/constellation_sim.py's constellation (eclipse: 614 workers
     sleeping periodically with pre-shed; radiation: 20 one-shot deaths
     under TC, SUPERVISION and NONE; stragglers: 41 workers at speed 3),
     each leap/loop, eclipse and radiation/TC also staged, with the famine
     path off and in tick mode, every mode equal to the leap/loop run but
     in `events`; `deque_apply` at the TC push-log width (83 lanes); a
     profiled 300-tick TC window; the drained W=100 runs of each scenario,
     card == CPU and equal to the reference's pinned (result, ticks,
     events), TC and pre-shed exact; the radiation schedule under TC as one
     6-point sweep (checkpoint interval 0, 40, 80 x NEIGHBOR, GLOBAL), every
     point equal to its own run;
  8. run time-varying link state (`phase_linkstate`): the reference's
     benchmarks/bench_sim_throughput.py `_dynamic_constellation` at W=4096
     (a wraparound 64x64 torus, orbit 1024 ticks x 2, 35% eclipse, 10% of
     the satellites battery-limited and sleeping in it periodically with a
     50-tick warning, seam handovers dark 10% of their 16-tick cycle; 359
     epochs), its routing tables built once (routing "auto": sparse, 4
     landmarks) — host seconds, the build report, the tables' bytes on the
     card — then the [main] workload cut at 1500 ticks under NEIGHBOR,
     ADAPTIVE and GLOBAL (leap, loop backend) and NEIGHBOR staged, with the
     famine path off and in tick mode, each equal to NEIGHBOR's leap/loop
     run but in `events`; ms/event against `[main]`'s; a profiled 300-tick
     window; then drained W=100 runs of the same recipe (10x10, FIB n=26
     cutoff=14): NEIGHBOR and GLOBAL on dense tables, NEIGHBOR on prebuilt
     sparse tables with 5x5 patches, each equal to the reference's pinned
     (result, ticks, events) and to the port's CPU run;
  9. run the flight recorder (`phase_trace`, `SimConfig(trace=...)`): the
     main path traced (a ring of 2^20 rows, 64 bins of 32 ticks) leap/loop,
     leap/staged, famine batch 0 and tick mode — every ring and time series
     equal, every other field equal to step 3's untraced run but `events`,
     and `events`, `emitted` and the ring's sha256 the reference's
     (TRACE_PINS); ms/event and device activities an event traced against
     untraced in profiled 300-tick windows; step 8's dynamic constellation
     traced under NEIGHBOR and GLOBAL (epoch events, the inclusive epoch
     clip, unreachable draws), each equal to its untraced run but in
     `events` and to its tick-mode run in the ring; drained W=100 runs (the
     three strategies, GLOBAL across a partitioned schedule at famine batch
     64, radiation under TC), card == CPU and the reference's pins; a traced
     3-seed `simulate_batch`, each seed equal to its own traced run;
  10. run open-loop arrivals (`phase_arrivals`, `simulate(arrivals=...)`) at
     W=4096 in the load–latency benchmark's shape: a FIB n=8 seed root, 64
     Zipf (s=1) ground stations injecting 8 requests of 512 work units a
     candidate, capacity 256, 2,000 ticks; (a) NEIGHBOR and GLOBAL at
     offered loads 0.2, 0.5 and 0.8 work units a worker-tick traced as one
     6-point sweep (a ring of 2^21 rows a point), every point's fields,
     ring and sojourn percentiles the reference's (ARR_PINS, a digest of
     every field), no ring drop, NEIGHBOR 0.8 equal to its own run; (b)
     NEIGHBOR 0.5 untraced leap/loop, leap/staged, famine batch 0 and tick
     mode, equal but in `events`, `events` the reference's, and a profiled
     300-tick window against [main]'s; (c) step 8's dynamic constellation
     with the diurnal rate schedule (sleepers as dead stations), the
     reference's, leap == tick; (d) tests/test_arrivals.py's four scenarios
     and its TC rollback run, card == CPU; (e) `f32math.log_f32` and
     `arrivals.gap_ticks`, card == CPU bit for bit; (f) `deque_apply` at
     the arrival path's push log (L = 17, C = 256), exact and timed;
  11. run the round executor (`phase_scheduler`, `scheduler.run_sweep`) at
     the paper's widest configuration, 16 nodes x 40 cores = 640 workers on
     a 25x26 grid, Fig. 3's settings (capacity 4096): (a) FIB_QUICK and
     UTS_QUICK, GLOBAL and NEIGHBOR x seeds 0-2 as one sweep each, every
     point's result, rounds, nodes, attempts, successes, overflow and
     per-worker digests the reference's (SCHED_PINS), FIB exact, the mean
     rounds per strategy and Fig. 4's gap; (b) paper_mesh's steady-phase FIB
     (GLOBAL and NEIGHBOR at seed 0), pinned the same way: its wall, rounds,
     ms a round, set-up apart, peak memory and a profiled 297-round window;
     (c) card == CPU at W=100 for every strategy, a link snapshot of the
     dynamic constellation and a max_rounds cut; (d) `steal_compact`
     (each steal sub-round's export) launched 8 times a loop iteration in
     each W=640 grid, counted from 0 just before it, and exact against its
     plain version at the grids' 1,280 and 3,840 rows of 4,096 slots;
  12-14. serve three models through `serve_loop.serve_requests` (one phase,
     `phase_serve`, each model in turn, random weights from seed 0, bf16):
     8 requests and 64 new tokens each; the path's kernels must launch
     exactly as its blocks say (an attention block `flash_attention` once in
     the prefill and `decode_attention` once a decode step, a recurrent
     block `rglru` and an rwkv block `wkv6` once in each); the same inputs
     then run teacher-forced through the plain versions of the path's
     kernels and every step's logits must agree within a stated tolerance;
     prefill and decode rates, peak device memory and the device's busy
     share are measured. The models: qwen2-0.5b at full width (24 layers,
     d 896, vocab 151936; prompt 512: 24 `flash_attention`, 24 x 63
     `decode_attention`), followed by `simulate_serving` on the launcher's
     request lengths, which must give the same stats on the card and on the
     CPU; rwkv6-1.6b at full width (24 layers, d 2048, 32 heads of 64, d_ff
     7168, vocab 65536, layernorm; prompt 512: 24 + 24 x 63 `wkv6`);
     recurrentgemma-9b at full width and depth (38 layers: 26 RG-LRU blocks
     and 12 MQA attention blocks with a 2048-token window, d 4096, 16 heads
     of 256 over 1 KV head, d_ff 12288, vocab 256000; prompt 2560, cache_len
     2632, a ring of 2048 that prefill writes past and decode wraps: 12
     `flash_attention`, 12 x 63 `decode_attention`, 26 + 26 x 63 `rglru`).

``python3 chip_smoke.py --turns PARENT`` runs only the main-path phase,
in turns with the checkout at PARENT (another commit's tree): parent, this
tree, this tree, parent, each in a process of its own, to compare two
commits on one card.

It prints the card's name and power limit, then one JSON line with each
kernel's launches on the paths that run it (each path's counts set to 0
just before it and read just after), error, times and bound (the attention
kernels' hd-256 numbers under `hd256_*`), and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
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
# tensor — the same recurrence with its sums in another order (fmaf, sums
# over lanes and warps, steps taken four at a time), the error growing with
# the values the state accumulates
WKV_RTOL, WKV_ATOL = 1e-4, 1e-5
# rglru against its plain version on the card, fp32 outputs and states:
# |kernel - plain| <= RGLRU_RTOL * max|plain| + RGLRU_ATOL over each compared
# tensor — the same operations in the same order, each rounded as the plain
# version rounds it; only expf and log1pf may differ from torch's by an ulp
RGLRU_RTOL, RGLRU_ATOL = 1e-5, 1e-6


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
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "C75" in line):
                print(f"[build] {name}: {line.strip()}")
    # the tensor-core instructions in the attention kernels' machine code:
    # wgmma (HGMMA) in flash_attention's bf16 kernel, mma.sync (HMMA) in both
    # head dims of decode_attention's
    for name, op, kernel, n_fns in (
            ("flash_attention", "HGMMA", "flash_attention_wgmma_kernel", 2),
            ("decode_attention", "HMMA", "decode_attention_mma_kernel", 2)):
        found = _sass_ops(build, name, op)
        if sum(kernel in fn for fn in found) != n_fns:
            raise SystemExit(f"{name}: {op} in {sorted(found)}, expected it in "
                             f"{n_fns} instantiations of {kernel}")
        for fn, shapes in found.items():
            print(f"[build] {name} SASS: {fn}: {op} {shapes}")


def _sass_ops(build, name: str, op: str) -> dict:
    """{function: {instruction shape: count}} of the SASS instructions `op`
    in the built library of kernel `name` (cuobjdump)."""
    sass = subprocess.run(
        [str(Path(build.nvcc_path()).with_name("cuobjdump")), "--dump-sass",
         str(build.lib_path(name))],
        capture_output=True, text=True, check=True).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif f" {op}." in line:
            shape = line.split(f"{op}.")[1].split()[0]
            found.setdefault(fn, {}).setdefault(shape, 0)
            found[fn][shape] += 1
    return found


def _deque_apply_at(torch, np, ops, ref, deque, rs, buf, bot, size, L):
    """The in-place `deque_apply` against its plain version (exactly equal,
    each run on a copy of the rings `buf`) with an L-lane push log holding
    repeated and out-of-range slots; rows with n = 0 or gated off through
    `deque.apply`'s `keep` must come back bit for bit. Timed beside the
    library yardstick, an in-place `index_put_` of the same winners (the
    dedup left untimed), with the bound of what the inputs need."""
    dev = torch.device("cuda")
    W, C, T = buf.shape

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)

    # push log: slots drawn from a few ring positions so lanes repeat, one
    # lane in 32 out of [0, C); live-lane counts n below the lane budget L
    # for most workers, 0 for some
    base = rs.integers(0, C, (W, 1))
    slot_np = (base + rs.integers(0, 3, (W, L))) % C
    out = rs.random((W, L)) < 1 / 32
    slot_np[out] = rs.choice([-1, C], int(out.sum()))
    slot = t(slot_np)
    rec = t(rs.integers(-2**31, 2**31 - 1, (W, L, T), dtype=np.int64))
    n = t(rs.integers(0, L + 1, W))
    keep = torch.as_tensor(rs.random(W) < 0.75, device=dev)
    new_k = ops.deque_apply_(buf.clone(), slot, rec, n)
    new_p = ref.deque_apply_(buf.clone(), slot, rec, n)
    gated = deque.apply(deque.DequeOps(buf0=buf.clone(), bot=bot, size=size,
                                       slot=slot, rec=rec, n=n), keep).buf
    # the library yardstick's winners: each live, in-range lane that no later
    # live lane of its worker overrides
    lanes = torch.arange(L, device=dev)[None, :]
    live = lanes < n[:, None]
    ok = live & (slot >= 0) & (slot < C)
    same = (slot[:, :, None] == slot[:, None, :]) & ok[:, None, :]
    later = same & (lanes[:, None, :] > lanes[:, :, None])
    win = ok & ~later.any(-1)
    w_idx = torch.arange(W, device=dev)[:, None].expand(W, L)[win]
    s_idx = slot.long()[win]
    vals = rec[win]
    new_l = buf.clone().index_put_((w_idx, s_idx), vals)
    torch.cuda.synchronize()
    err_da = _max_abs_err([(new_k, new_p)])
    if not (torch.equal(new_k, new_p) and torch.equal(new_l, new_p)
            and torch.equal(ref.deque_apply(buf, slot, rec, n), new_p)):
        raise SystemExit(f"deque_apply disagrees with its plain version at "
                         f"W={W}, L={L} (max abs err {err_da})")
    still = ~keep | (n == 0)
    if not (torch.equal(gated[still], buf[still])
            and torch.equal(gated[~still], new_p[~still])):
        raise SystemExit(f"deque_apply at W={W}, L={L}: a gated or n = 0 row "
                         f"changed, or a kept row differs from the full commit")
    n_live, n_win = int(live.sum()), int(win.sum())
    da_bytes = W * 4 + n_live * 4 + n_win * T * 4 * 2
    m = torch.minimum(n, torch.full_like(n, L)).clamp(min=0).long()
    da_ops = int((m * (m - 1) // 2).sum())   # the later-lane scans' compares
    # kernel and yardstick write the same records into one copy of the
    # rings (where a buffer lies moves the time by a few percent at G·W
    # rows), timed in turns (kernel, library, library, kernel, kernel,
    # library); each keeps its median
    buf_t, buf_p = buf.clone(), buf.clone()

    def kern():
        return ops.deque_apply_(buf_t, slot, rec, n)

    def lib():
        return buf_t.index_put_((w_idx, s_idx), vals)

    runs = {kern: [], lib: []}
    for fn in (kern, lib, lib, kern, kern, lib):
        runs[fn].append(_device_ms(torch, fn))
    da = {
        "ms": sorted(runs[kern])[1], "call_ms": _call_ms(torch, kern),
        "plain_ms": _device_ms(torch, lambda: ref.deque_apply_(buf_p, slot, rec, n)),
        "library_ms": sorted(runs[lib])[1],
        "max_abs_err": err_da, "bytes": da_bytes, "ops": da_ops,
        "live": n_live, "winners": n_win,
        "turns": {"kernel": runs[kern], "library": runs[lib]}}
    da["bound_ms"], da["bound_by"] = _bound_ms(da_bytes, da_ops)
    return da


def _export_inputs(torch, np, ref, rs, W, C):
    """Random rings of W rows and C slots for `steal_compact`: a quarter of
    the bottoms parked near the wrap, an eighth of the sizes below their
    grants, a twelfth of the grants above the staging width."""
    G, T = ref.GRANT_WIDTH, 4

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device="cuda")

    buf = t(rs.integers(-2**31, 2**31 - 1, (W, C, T), dtype=np.int64))
    bot = rs.integers(0, C, W)
    bot[: W // 4] = C - 1 - rs.integers(0, 4, W // 4)
    size = rs.integers(0, C + 1, W)
    size[W // 8: W // 4] = rs.integers(0, 3, W // 8)   # grants > size
    grants = rs.integers(0, G + 1, W)
    grants[W // 4: W // 3] += rs.integers(1, 4, W // 3 - W // 4)   # > the width
    return buf, t(bot), t(size), t(grants)


def _steal_compact_at(torch, ops, ref, inputs, width: int) -> dict:
    """`steal_compact` against its plain version on `inputs` at export
    `width` (exactly equal), timed with its bound."""
    buf, bot, size, grants = inputs
    W = buf.shape[0]
    out_k = ops.steal_compact(buf, bot, size, grants, width)
    out_p = ref.steal_compact(buf, bot, size, grants, width)
    torch.cuda.synchronize()
    err = _max_abs_err(zip(out_k, out_p))
    if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
        raise SystemExit(f"steal_compact disagrees with its plain version at "
                         f"W={W}, C={buf.shape[1]}, width {width} (max abs err {err})")
    g = torch.minimum(grants.clamp(max=width), size).clamp(min=0)
    nbytes = int(g.sum()) * 16 + W * width * 16 + 3 * W * 4 + 2 * W * 4
    nops = W * ref.GRANT_WIDTH * 8

    def kern():
        return ops.steal_compact(buf, bot, size, grants, width)

    r = {"ms": _device_ms(torch, kern), "call_ms": _call_ms(torch, kern),
         "plain_ms": _device_ms(torch, lambda: ref.steal_compact(
             buf, bot, size, grants, width)),
         "library_ms": None, "max_abs_err": err, "bytes": nbytes, "ops": nops}
    r["bound_ms"], r["bound_by"] = _bound_ms(nbytes, nops)
    return r


def _sim_kernels_at(torch, np, ops, ref, deque, tasks, rs, W):
    """`steal_compact` (export widths ref.GRANT_WIDTH and 4) and `deque_apply`
    against their plain versions at W rows of capacity CAP_MAIN (exactly
    equal), timed with their bounds."""
    C = CAP_MAIN
    L = tasks.EXPAND_K + 1
    inputs = _export_inputs(torch, np, ref, rs, W, C)
    sc = _steal_compact_at(torch, ops, ref, inputs, ref.GRANT_WIDTH)
    r = _steal_compact_at(torch, ops, ref, inputs, 4)
    sc.update({f"width4_{k}": r[k] for k in (
        "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")})
    sc["max_abs_err"] = max(sc["max_abs_err"], r["max_abs_err"])
    buf, bot, size, _ = inputs

    da = _deque_apply_at(torch, np, ops, ref, deque, rs, buf, bot, size, L)
    for name, r in (("steal_compact", sc), ("deque_apply", da)):
        extra = (f"; at width 4: kernel {r['width4_ms']:.6f} ms, plain "
                 f"{r['width4_plain_ms']:.6f} ms, bound {r['width4_bound_ms']:.6f} ms"
                 if name == "steal_compact" else
                 f"; L={L}, {r['live']} live lanes, {r['winners']} winners, "
                 f"library = in-place index_put_; medians of three in turns, "
                 f"kernel {r['turns']['kernel']} ms, library "
                 f"{r['turns']['library']} ms")
        print(f"[kernels] {name} at {W} rows, C={C}: exact; device per launch: "
              f"kernel {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, library "
              f"{r['library_ms']} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}, {r['bytes']} bytes); eager wrapper call "
              f"{r['call_ms']:.6f} ms{extra}")
    return sc, da


def phase_kernels(torch, np, ops, ref, deque, tasks):
    """The simulator kernels against their plain versions at the main path's
    rows (W=4096, C=64) and at the sweep's (18 points x 4096 = 73,728 rows),
    beside the launch floor. The sweep's numbers go under `sweep_*`."""
    dev = torch.device("cuda")
    rs = np.random.default_rng(20261016)
    sc, da = _sim_kernels_at(torch, np, ops, ref, deque, tasks, rs, W_MAIN)
    sc_g, da_g = _sim_kernels_at(torch, np, ops, ref, deque, tasks, rs,
                                 W_MAIN * len(SWEEP_GRID))
    for main, grid in ((sc, sc_g), (da, da_g)):
        main["max_abs_err"] = max(main["max_abs_err"], grid["max_abs_err"])
        main.update({f"sweep_{k}": grid[k] for k in (
            "ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "width4_ms", "width4_bound_ms") if k in grid})
    # the launch floor: a one-element elementwise op in the same harness, a
    # yardstick for the tiny kernels (the port never calls it)
    one = torch.zeros(1, device=dev)
    floor = _device_ms(torch, lambda: one.add_(1.0))
    print(f"[kernels] launch floor: a one-element add_ takes {floor:.6f} ms a launch "
          f"on the device (graph replay, as every kernel time here); "
          f"each kernel's bound or the floor, whichever is larger: "
          f"steal_compact {max(sc['bound_ms'], floor):.6f} ms at {W_MAIN} rows, "
          f"{max(sc_g['bound_ms'], floor):.6f} ms at {W_MAIN * len(SWEEP_GRID)}; "
          f"deque_apply {max(da['bound_ms'], floor):.6f} ms at {W_MAIN} rows, "
          f"{max(da_g['bound_ms'], floor):.6f} ms at {W_MAIN * len(SWEEP_GRID)}")
    return {"steal_compact": sc, "deque_apply": da}, floor


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
    bf16: at head dim 64 (qwen2 serving) and at head dim 256 with 16 query
    heads over one KV head (recurrentgemma serving). The first case of each
    kernel at each head dim is that serving path's shape; it is also timed
    (kernel, plain version, eager call, library call). The hd-64 numbers
    keep their keys; the hd-256 ones go under `hd256_*`."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    bf16 = torch.bfloat16

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
              f"x |plain|{'' if required else '; not required'}); equal to the "
              f"plain version: {bool(torch.equal(got, want))}")
        if required and not ok:
            raise SystemExit(f"{name} {what} disagrees with its plain version")
        return err

    def band(Sq, Sk, causal, window):
        qp = torch.arange(Sq, device=dev)[:, None]
        kp = torch.arange(Sk, device=dev)[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
        if causal:
            mask &= qp >= kp
        if window:
            mask &= (qp - kp) < window
        return mask

    out = {"flash_attention": {}, "decode_attention": {}}
    # flash attention: (B, KV, G, S, hd, causal, window, q scale); the first
    # of each head dim is its serving path's prefill (timed). Besides: S
    # shorter than a key tile, window 1 at one past a 128-row tile, one past
    # the hd-256 window, and scores spread wide (q x 8: the running max
    # moves by large steps, so alpha and p's rounding against a stale max
    # are exercised)
    flash_cases = [(8, 2, 7, 512, 64, True, 0, 1), (1, 2, 7, 2048, 64, True, 0, 1),
                   (2, 2, 7, 500, 64, True, 0, 1), (2, 2, 7, 500, 64, True, 128, 1),
                   (1, 2, 7, 333, 64, False, 0, 1), (1, 2, 7, 40, 64, True, 0, 1),
                   (2, 2, 7, 129, 64, True, 1, 1), (2, 2, 7, 700, 64, True, 0, 8),
                   (8, 1, 16, 2560, 256, True, 2048, 1), (2, 1, 16, 777, 256, True, 100, 1),
                   (1, 1, 16, 300, 256, False, 0, 1), (1, 2, 7, 250, 256, True, 0, 1),
                   (2, 1, 16, 2049, 256, True, 2048, 1), (1, 1, 16, 600, 256, False, 0, 8)]
    errs, timed = [], set()
    for B, KV, G, S, hd, causal, window, qscale in flash_cases:
        q = (rnd(B, KV, G, S, hd).float() * qscale).to(bf16)
        k, v = rnd(B, KV, S, hd), rnd(B, KV, S, hd)
        errs.append(check("flash_attention",
                          f"B={B} KV={KV} G={G} S={S} hd={hd} causal={causal} "
                          f"window={window} q x {qscale}",
                          ops.flash_attention(q, k, v, causal=causal, window=window),
                          ref.flash_attention(q, k, v, causal=causal, window=window)))
        if hd in timed:
            continue
        timed.add(hd)
        nbytes, nops = _flash_work(B, KV, G, S, hd, causal, window, 2)
        qh = q.view(B, KV * G, S, hd)
        mask = band(S, S, causal, window)

        def lib():
            if window:
                return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(qh, k, v, is_causal=causal,
                                                  enable_gqa=True)

        def kern():
            return ops.flash_attention(q, k, v, causal=causal, window=window)

        def plain():
            return ref.flash_attention(q, k, v, causal=causal, window=window)

        # the plain version takes tens of ms a call at the hd-256 shape:
        # fewer calls a graph there
        few = dict(calls=1, reps=3) if hd == 256 else {}
        r = {"ms": _device_ms(torch, kern), "call_ms": _call_ms(torch, kern),
             "plain_ms": _device_ms(torch, plain, **few),
             "library_ms": _device_ms(torch, lib), "bytes": nbytes, "ops": nops}
        r["bound_ms"], r["bound_by"] = _bound_ms(nbytes, nops, BF16_OPS_PER_S)
        check("flash_attention", f"hd={hd} library call (SDPA) vs plain",
              lib().view_as(q), plain(), required=False)
        out["flash_attention"].update(
            r if hd == 64 else {f"hd256_{key}": val for key, val in r.items()})
    out["flash_attention"]["max_abs_err"] = max(errs)

    # decode attention: (B, KV, G, T, hd, lengths); the first of each head
    # dim is its serving path's decode (timed): qwen2's ragged 512..575
    # written positions of a 584-slot cache, recurrentgemma's full ring of
    # 2048 slots. Besides: lengths at the bf16 kernel's edges, a warp's
    # 16-position tile, a block's chunk (128 at hd 64, 256 at hd 256) and a
    # cluster's chunks (16 x 128, 8 x 256) +-1, a cache longer than a
    # cluster, T not a multiple of a chunk, empty rows, G 16 at hd 64 and G 1
    # at hd 256
    g2 = torch.Generator().manual_seed(7)
    decode_cases = [(8, 2, 7, 584, 64, torch.randint(512, 576, (8,), generator=g2).tolist()),
                    (4, 2, 7, 4096, 64, [0, 4096, 1, 2500]), (3, 2, 7, 100, 64, [64, 65, 100]),
                    (8, 2, 7, 584, 64, [1, 15, 16, 17, 127, 128, 129, 584]),
                    (2, 1, 16, 300, 64, [129, 300]),
                    (4, 2, 7, 4096, 64, [2047, 2048, 2049, 4096]),
                    (8, 1, 16, 2048, 256, [2048] * 8),
                    (4, 1, 16, 2048, 256, [0, 1, 1000, 2047]), (3, 2, 7, 100, 256, [31, 33, 100]),
                    (10, 1, 16, 2048, 256, [1, 16, 17, 63, 64, 65, 255, 256, 257, 2048]),
                    (4, 1, 16, 2600, 256, [2047, 2048, 2049, 2600]),
                    (2, 2, 1, 333, 256, [17, 333])]
    errs, timed = [], set()
    for B, KV, G, T, hd, lengths in decode_cases:
        q, kc, vc = rnd(B, KV, G, hd), rnd(B, KV, T, hd), rnd(B, KV, T, hd)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = ops.decode_attention(q, kc, vc, ln)
        errs.append(check("decode_attention",
                          f"B={B} KV={KV} G={G} T={T} hd={hd} lengths={lengths}",
                          got, ref.decode_attention(q, kc, vc, ln)))
        if 0 in lengths and not bool((got[lengths.index(0)] == 0).all()):
            raise SystemExit("decode_attention: a row of length 0 is not 0")
        if hd in timed:
            continue
        timed.add(hd)
        nbytes, nops = _decode_work(KV, G, hd, lengths, 2)
        mask = (torch.arange(T, device=dev)[None, :] < ln[:, None])[:, None, None, :]
        qh = q.view(B, KV * G, 1, hd)

        def lib():
            return F.scaled_dot_product_attention(qh, kc, vc, attn_mask=mask,
                                                  enable_gqa=True)

        r = {"ms": _device_ms(torch, lambda: ops.decode_attention(q, kc, vc, ln)),
             "call_ms": _call_ms(torch, lambda: ops.decode_attention(q, kc, vc, ln)),
             "plain_ms": _device_ms(torch, lambda: ref.decode_attention(q, kc, vc, ln)),
             "library_ms": _device_ms(torch, lib), "bytes": nbytes, "ops": nops}
        r["bound_ms"], r["bound_by"] = _bound_ms(nbytes, nops, BF16_OPS_PER_S)
        # after hundreds of launches (graph replays included) the tickets
        # must be back at 0: the same inputs give the same bits
        again = ops.decode_attention(q, kc, vc, ln)
        torch.cuda.synchronize()
        if not torch.equal(again, got):
            raise SystemExit(f"decode_attention hd={hd}: a repeated call differs from "
                             f"the first")
        print(f"[kernels] decode_attention hd={hd}: repeated call after the timing "
              f"runs equals the first, bit for bit")
        check("decode_attention", f"hd={hd} library call (SDPA) vs plain",
              lib().view_as(q), ref.decode_attention(q, kc, vc, ln), required=False)
        out["decode_attention"].update(
            r if hd == 64 else {f"hd256_{key}": val for key, val in r.items()})
    out["decode_attention"]["max_abs_err"] = max(errs)
    for name, r in out.items():
        for hd, pre in ((64, ""), (256, "hd256_")):
            print(f"[kernels] {name}: device per launch at the hd-{hd} serving "
                  f"shape: kernel {r[pre + 'ms']:.6f} ms, plain "
                  f"{r[pre + 'plain_ms']:.6f} ms, library {r[pre + 'library_ms']:.6f} "
                  f"ms, bound {r[pre + 'bound_ms']:.6f} ms ({r[pre + 'bound_by']}; "
                  f"{r[pre + 'bytes']} bytes, {r[pre + 'ops']} FLOP); eager wrapper "
                  f"call {r[pre + 'call_ms']:.6f} ms")
    return out


def _wkv6_work(B, S, H, hd, state: bool, elt: int = 4):
    """(bytes, FLOPs) of the WKV6 recurrence: r, k and v (element size
    `elt`), w and u read once, the output written once, the given state read
    once and the final state written once. FLOPs as the sequence kernel
    takes the steps: per (b, h) and quad of four steps, 17·hd² (per state
    element four FMAs for r·S, a product and three FMAs for the sum of
    k v, one FMA for the state) plus 71·hd (per row the quad's bonus terms,
    cross terms and decay products, 39; per column the warps' sums, the
    cross terms' v and the bonus's v, 32); per step left over (S mod 4, and
    decode's one step), 5·hd² (an FMA for r·S, a product and an FMA for the
    state) plus 8·hd (bonus 3 a row, the sums and c v 5 a column)."""
    n = B * S * H * hd
    st = B * H * hd * hd * 4
    nbytes = 3 * n * elt + 2 * n * 4 + H * hd * 4 + st * (2 if state else 1)
    quads, single = divmod(S, 4)
    nops = B * H * (quads * (17 * hd * hd + 71 * hd) + single * (5 * hd * hd + 8 * hd))
    return nbytes, nops


def _start_wkv6_seq_only(build):
    """Start nvcc on `wkv6.cu` with WKV6_STEP_KERNEL=0 (no step kernel, so
    S = 1 takes the sequence kernel), beside the build of the six kernels;
    returns (library path, the nvcc process or None if it is built)."""
    own = build.lib_path("wkv6")
    path = own.with_name(own.stem + "-seq-only.so")
    if path.exists():
        return path, None
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-DWKV6_STEP_KERNEL=0", "-o", str(tmp),
           str(build.CSRC / "wkv6.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def stop():  # if a phase before `phase_wkv6` fails
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return path, (tmp, proc)


def _load_wkv6_seq_only(build, started):
    import ctypes
    path, pending = started
    if pending is not None:
        tmp, proc = pending
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"wkv6 without its step kernel: nvcc exited "
                             f"{proc.returncode}\n{log}")
        tmp.replace(path)
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in build._SIGNATURES["wkv6"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _wkv6_inputs(torch, gen, B, S, H, hd, state, dtype=None):
    """r, k, v, w, u and a state as rwkv6's time mix makes them: r, k, v
    from bf16 matmuls of unit-scale activations with normal(0, 0.02)
    weights, left in bf16 as the model passes them (dtype bfloat16) or cast
    to fp32 (the default); w = exp(-exp(w0 + lora)) with w0 per channel in
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
    r, k, v = ((x @ rnd(D, D, scale=0.02).to(bf16)).to(dtype or torch.float32)
               .view(B, S, H, hd) for _ in range(3))
    w0 = torch.rand((D,), generator=gen, device=dev) * 5.5 - 6.0
    lora = (x @ rnd(D, 64, scale=0.02).to(bf16)) @ rnd(64, D, scale=0.02).to(bf16)
    w = torch.exp(-torch.exp(w0 + lora.float())).view(B, S, H, hd)
    u = rnd(H, hd, scale=0.3)
    if state is None:
        return r, k, v, w, u, None
    if state == "zeros":
        return r, k, v, w, u, torch.zeros((B, H, hd, hd), device=dev)
    return r, k, v, w, u, rnd(B, H, hd, hd, scale=0.3)


def phase_wkv6(torch, ops, ref, build, seq_only):
    """`wkv6` against its plain version on the card. The first two cases
    are rwkv6 serving's prefill (bf16 r, k, v as the time mix hands them
    over, a zero state tensor given) and decode (a carried state); the next
    two the same shapes with fp32 r, k, v; all four are timed (kernel, plain
    version, eager call). Then fp32 and bf16 cases from zero and given
    states at S = 7 (below a tile of the sequence kernel's ring), one past a
    tile, 1000 (ragged) and 1; last, the bf16 prefill once more, which must
    equal the first call bit for bit. One block runs each (b, h), so every
    B·H is whole blocks. At the bf16 decode shape the sequence kernel
    (`seq_only`, from `_start_wkv6_seq_only`) is held against the plain
    version too and timed in turns with the step kernel: step, sequence,
    step."""
    gen = torch.Generator(device=torch.device("cuda"))
    gen.manual_seed(20261018)
    bf16 = torch.bfloat16
    tile = build.load("wkv6").wkv6_tile()
    cases = [(8, 512, 32, "zeros", bf16), (8, 1, 32, "random", bf16),
             (8, 512, 32, "zeros", None), (8, 1, 32, "random", None),
             (8, 512, 32, "random", None), (8, 512, 32, None, None),
             (2, 7, 32, None, None), (2, 1000, 4, "random", None), (3, 1, 4, None, None),
             (2, tile + 1, 32, "random", bf16), (3, 1000, 4, None, bf16),
             (2, 7, 4, "random", bf16)]
    errs, timed, first = [], {}, None
    for i, (B, S, H, state, dtype) in enumerate(cases):
        r, k, v, w, u, s0 = _wkv6_inputs(torch, gen, B, S, H, 64, state, dtype)
        got = ops.wkv6(r, k, v, w, u, s0)
        want = ref.wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        kind = "bf16" if dtype is bf16 else "fp32"
        for what, g, p in (("out", got[0], want[0]), ("final state", got[1], want[1])):
            err = float((g - p).abs().max())
            allowed = WKV_RTOL * float(p.abs().max()) + WKV_ATOL
            errs.append(err)
            print(f"[kernels] wkv6 B={B} S={S} H={H} hd=64 {kind} r, k, v, state "
                  f"{state or 'none'}, {what}: max abs err "
                  f"{err:.3e}, max |plain| {float(p.abs().max()):.4f}, allowed "
                  f"{allowed:.3e} ({WKV_RTOL} x max|plain| + {WKV_ATOL})")
            if not err <= allowed or not bool(torch.isfinite(g).all()):
                raise SystemExit(f"wkv6 B={B} S={S} {kind} {what} disagrees with its "
                                 f"plain version")
        if i == 0:
            first = (r, k, v, w, u, s0), got
        if i < 4:
            elt = 2 if dtype is bf16 else 4
            nbytes, nops = _wkv6_work(B, S, H, 64, s0 is not None, elt)

            def kern():
                return ops.wkv6(r, k, v, w, u, s0)

            def plain():
                return ref.wkv6(r, k, v, w, u, s0)

            t = {"ms": _device_ms(torch, kern), "call_ms": _call_ms(torch, kern),
                 # the plain version launches ~10 kernels a step: few calls a graph
                 "plain_ms": _device_ms(torch, plain, calls=2, reps=5),
                 "library_ms": None, "bytes": nbytes, "ops": nops}
            t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, nops)
            what = "prefill" if S > 1 else "decode"
            timed[(what, kind)] = t
            if i == 1:
                t.update(_wkv6_seq_at_decode(torch, ops, build, seq_only, kern, want))
            print(f"[kernels] wkv6 at the serving {what} shape B={B} S={S} H={H}, {kind} "
                  f"r, k, v: kernel {t['ms']:.6f} ms, plain {t['plain_ms']:.6f} ms, "
                  f"library none (no single PyTorch call), bound {t['bound_ms']:.6f} ms "
                  f"({t['bound_by']}; {nbytes} bytes, {nops} FLOP); eager wrapper call "
                  f"{t['call_ms']:.6f} ms")
    again = ops.wkv6(*first[0])
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(again, first[1]))
    print(f"[kernels] wkv6 bf16 prefill called again after the timing runs: "
          f"bit-equal to the first call: {same}")
    if not same:
        raise SystemExit("wkv6: a repeated call differs from the first")
    out = dict(timed[("prefill", "bf16")])
    out["max_abs_err"] = max(errs)
    dec, pre32, dec32 = (timed[("decode", "bf16")], timed[("prefill", "fp32")],
                         timed[("decode", "fp32")])
    out["decode_ms"] = dec["ms"]
    out["decode_plain_ms"] = dec["plain_ms"]
    out["decode_bound_ms"] = dec["bound_ms"]
    out["decode_seq_kernel_ms"] = dec["seq_kernel_ms"]
    out["fp32_ms"] = pre32["ms"]
    out["fp32_bound_ms"] = pre32["bound_ms"]
    out["fp32_decode_ms"] = dec32["ms"]
    out["fp32_decode_bound_ms"] = dec32["bound_ms"]
    return {"wkv6": out}


def _wkv6_seq_at_decode(torch, ops, build, seq_only, kern, want):
    """The sequence kernel at the decode shape, through `ops.wkv6` with the
    library built without the step kernel swapped in: within the tolerance
    of the plain version's `want`, then timed, then the step kernel timed
    again."""
    lib = _load_wkv6_seq_only(build, seq_only)
    own = build._LIBS["wkv6"]
    build._LIBS["wkv6"] = lib
    try:
        got = kern()
        torch.cuda.synchronize()
        for what, g, p in (("out", got[0], want[0]), ("final state", got[1], want[1])):
            err = float((g - p).abs().max())
            allowed = WKV_RTOL * float(p.abs().max()) + WKV_ATOL
            print(f"[kernels] wkv6 sequence kernel at S=1 (built without the step "
                  f"kernel), {what}: max abs err {err:.3e}, allowed {allowed:.3e}")
            if not err <= allowed or not bool(torch.isfinite(g).all()):
                raise SystemExit(f"wkv6 sequence kernel at S=1: {what} disagrees with "
                                 f"its plain version")
        seq_ms = _device_ms(torch, kern)
    finally:
        build._LIBS["wkv6"] = own
    step_ms = _device_ms(torch, kern)
    print(f"[kernels] wkv6 at the serving decode shape B=8 S=1 H=32, bf16 r, k, v, in "
          f"turns: step kernel (above), then the sequence kernel {seq_ms:.6f} ms, then "
          f"the step kernel {step_ms:.6f} ms a launch")
    return {"seq_kernel_ms": seq_ms, "step_again_ms": step_ms}


def _rglru_work(B, S, W, elt, h0: bool):
    """(bytes, operations) of the RG-LRU recurrence: x, r and i read once
    (element size `elt`), lam and a given h0 read once, h (fp32) and the
    final h written once; per element ~12 operations (the decay's two
    exponentials, the gate's square root, the products and sums)."""
    n = B * S * W
    nbytes = 3 * n * elt + W * 4 + B * W * 4 * (2 if h0 else 1) + n * 4
    return nbytes, 12 * n


def phase_rglru(torch, ops, ref, build):
    """`rglru` against its plain version on the card. The first case is
    recurrentgemma serving's prefill (bf16 inputs, a zero h0 tensor given,
    as the model passes it), the second its decode (S=1, a carried h0);
    both are timed (kernel, plain version, eager call) and must equal the
    plain version bit for bit. Then a ragged S, a long one, fp32 inputs, S
    at the TMA ring's edges (a tile of 16 steps, 3 tiles in the ring, +-1),
    W not a multiple of a block's 32 channels, and a W whose rows are not
    whole 16-byte units (the per-channel kernel)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261019)
    bf16, f32 = torch.bfloat16, torch.float32
    lib = build.load("rglru")
    cases = [(8, 2560, 4096, bf16, "zeros"), (8, 1, 4096, bf16, "random"),
             (2, 7, 4096, bf16, None), (1, 8192, 512, bf16, "random"),
             (2, 300, 4096, f32, "random"), (3, 1, 96, f32, None),
             (2, 15, 1000, bf16, "random"), (2, 16, 1000, bf16, None),
             (2, 17, 1000, bf16, "random"), (2, 47, 1000, bf16, "zeros"),
             (2, 48, 1000, bf16, "random"), (2, 49, 1000, bf16, "random"),
             (3, 33, 100, f32, "random"), (2, 20, 300, bf16, "random")]
    errs, timed = [], {}
    for n, (B, S, W, dt, state) in enumerate(cases):
        # as the recurrent block makes them: x a conv output, r and i
        # sigmoid gates; lam ~ N(0, 1.5^2) spans fast and slow decays
        x = torch.randn((B, S, W), generator=gen, device=dev).to(dt)
        r = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=dev)).to(dt)
        i = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=dev)).to(dt)
        lam = torch.randn((W,), generator=gen, device=dev) * 1.5
        h0 = (None if state is None else torch.zeros((B, W), device=dev)
              if state == "zeros" else torch.randn((B, W), generator=gen, device=dev))
        got = ops.rglru(x, r, i, lam, h0)
        want = ref.rglru(x, r, i, lam, h0)
        torch.cuda.synchronize()
        kernel = ("TMA-fed sequence kernel" if lib.rglru_uses_tma(S, W, int(dt == bf16))
                  else "per-channel kernel")
        for what, g, pl in (("h", got[0], want[0]), ("final h", got[1], want[1])):
            err = float((g - pl).abs().max())
            allowed = RGLRU_RTOL * float(pl.abs().max()) + RGLRU_ATOL
            exact = bool(torch.equal(g, pl))
            errs.append(err)
            print(f"[kernels] rglru B={B} S={S} W={W} {str(dt)[6:]} h0 "
                  f"{state or 'none'} ({kernel}), {what}: max abs err {err:.3e}, "
                  f"max |plain| {float(pl.abs().max()):.4f}, allowed {allowed:.3e} "
                  f"({RGLRU_RTOL} x max|plain| + {RGLRU_ATOL}); equal to the plain "
                  f"version: {exact}")
            if not err <= allowed or not bool(torch.isfinite(g).all()):
                raise SystemExit(f"rglru B={B} S={S} {what} disagrees with its "
                                 f"plain version")
            if n < 2 and not exact:
                raise SystemExit(f"rglru at the serving shape B={B} S={S}: {what} is "
                                 f"not bit-equal to the plain version")
        if n < 2:
            nbytes, nops = _rglru_work(B, S, W, x.element_size(), h0 is not None)

            def kern():
                return ops.rglru(x, r, i, lam, h0)

            def plain():
                return ref.rglru(x, r, i, lam, h0)

            t = {"ms": _device_ms(torch, kern), "call_ms": _call_ms(torch, kern),
                 # the plain version launches ~2 kernels a step: few calls a graph
                 "plain_ms": _device_ms(torch, plain, calls=1 if S > 1 else 50,
                                        reps=3 if S > 1 else 15),
                 "library_ms": None, "bytes": nbytes, "ops": nops}
            t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, nops)
            timed["prefill" if n == 0 else "decode"] = t
            print(f"[kernels] rglru at the serving {'prefill' if n == 0 else 'decode'} "
                  f"shape B={B} S={S} W={W}: kernel {t['ms']:.6f} ms, plain "
                  f"{t['plain_ms']:.6f} ms, library none (no single PyTorch call), "
                  f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}; {nbytes} bytes, "
                  f"{nops} operations); eager wrapper call {t['call_ms']:.6f} ms")
    out = dict(timed["prefill"])
    out["max_abs_err"] = max(errs)
    out["decode_ms"] = timed["decode"]["ms"]
    out["decode_plain_ms"] = timed["decode"]["plain_ms"]
    out["decode_bound_ms"] = timed["decode"]["bound_ms"]
    return {"rglru": out}


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


# the reference's (`repro.core.simulator.simulate`, JAX on a CPU) loop
# iterations at the main path's configuration, by famine_batch: its default
# 64 and the fast path off; the port must count the same
MAIN_EVENTS = {64: 287, 0: 667}


def _main_setup(sim, topo, tasks):
    mesh = topo.MeshTopology.square(W_MAIN)
    wl = tasks.FibWorkload(n=48, cutoff=28, max_leaf_cost=2048)
    base = dict(strategy=sim.stealing.Strategy.NEIGHBOR, hop_ticks=5,
                capacity=CAP_MAIN, max_ticks=1500)
    return mesh, wl, base


# the main path's runs: label, SimConfig fields beyond `base`, the kernel
# its deque backend launches (the first is the default: the loop backend,
# famine_batch 64)
# [main]'s profiled 300-tick windows by run label: ms/event, device
# activities an event, busy share (later phases' ratios read them)
MAIN_WINDOW: dict = {}
MAIN_RUNS = (("leap/loop", {}, "steal_compact"),
             ("leap/staged", {"deque_backend": "staged"}, "deque_apply"),
             ("leap/loop fb=0", {"famine_batch": 0}, "steal_compact"),
             ("leap/staged fb=0", {"famine_batch": 0, "deque_backend": "staged"},
              "deque_apply"),
             ("tick/staged", {"step_mode": "tick", "deque_backend": "staged"},
              "deque_apply"))


def phase_main_path(torch, np, sim, topo, tasks, ops):
    """W=4096 Starlink-scale closed run on the card: both deque backends at
    famine_batch 64 (the default) and 0, and tick mode. Every run's fields
    must agree, `events` aside, and `events` must equal the reference's."""
    mesh, wl, base = _main_setup(sim, topo, tasks)
    runs, launches, profiled, ms_event = {}, {}, {}, {}
    # a short run of each backend first, untimed: a process's first capture
    # and first use of a kernel library cost a few tenths of a second
    for backend in ("staged", "loop"):
        sim.simulate(wl, mesh, sim.SimConfig(**{**base, "max_ticks": 20},
                                             deque_backend=backend))
    for label, extra, kernel in MAIN_RUNS:
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
        ms_event[label] = dt / r.events * 1e3
        launches.setdefault(kernel, counts[kernel])
        print(f"[main] W={W_MAIN} {label}: ticks={r.ticks} events={r.events} "
              f"wall={dt:.3f} s ticks/s={r.ticks / dt:.2f} "
              f"events/s={r.events / dt:.2f} ms/event={dt / r.events * 1e3:.3f} "
              f"nodes={r.nodes} overflow={r.overflow} "
              f"hiwater={int(r.per_worker_hiwater.max())} launches={counts}")
    first = runs["leap/loop"]
    for label, r in runs.items():
        _assert_equal(np, first, r, skip=("events",),
                      what=f"leap/loop vs {label}")
        if label.startswith("leap"):
            want = MAIN_EVENTS[0 if "fb=0" in label else 64]
            if r.events != want:
                raise SystemExit(f"{label}: {r.events} events, the reference "
                                 f"counts {want}")
    if first.ticks != base["max_ticks"] or first.nodes <= 0 or first.overflow != 0:
        raise SystemExit(f"main path: unexpected result {first.ticks=} "
                         f"{first.nodes=} {first.overflow=}")
    print(f"[main] every run equal field for field but events; events = the "
          f"reference's ({MAIN_EVENTS[64]} at famine_batch 64, {MAIN_EVENTS[0]} at 0)")
    # where the time goes: a 300-tick window of each run, timed unprofiled,
    # then again under the profiler (the graph replays' kernels)
    for label, extra, kernel in MAIN_RUNS:
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
        profiled.setdefault(kernel, k_ms / k_n)
        MAIN_WINDOW[label] = (wall_ms / ev, n_dev / ev, busy / wall_ms)
        print(f"[profile] W={W_MAIN} {label}, 300 ticks, {ev} events: device "
              f"busy {busy:.3f} ms of {wall_ms:.3f} ms wall (busy share "
              f"{busy / wall_ms:.4f}); {n_dev} device activities = "
              f"{n_dev / ev:.1f} per event; {kernel} {k_n}x, "
              f"{k_ms / k_n * 1e3:.3f} us each")
        for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
            print(f"[profile]   {ms:9.3f} ms {cnt:7d}x {name[:90]}")
    return launches, profiled, first, ms_event["leap/loop"]


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


# the sweep: the crossover's own axes over the main path's configuration,
# strategy x tau x seed (18 points, G·W = 73,728 workers in one carry)
SWEEP_GRID = tuple((strategy, tau, seed) for strategy in ("neighbor", "global")
                   for tau in (2, 5, 10) for seed in (0, 1, 2))


def _sweep_params(sim, grid):
    code = sim.stealing.strategy_code
    return [sim.SimParams(strategy=code(s), hop_ticks=tau, seed=seed)
            for s, tau, seed in grid]


def phase_sweep(torch, np, sim, topo, tasks, ops, main_run):
    """The 18-point grid at W=4096 in one `simulate_sweep` (one core call,
    one graph capture): every point equal, field for field with `events`,
    to the port's per-point `simulate` on the card, the (neighbor, 5, 0)
    point equal to `[main]`'s leap/loop run; walls of the grid and of the
    per-point runs, a profiled 300-tick window of the grid; then a staged
    sweep of 6 points (`deque_apply` at G·W rows) equal to the loop sweep's.
    Returns (launches by kernel, steal_compact's in-graph ms a launch)."""
    mesh, wl, base = _main_setup(sim, topo, tasks)
    cfg = sim.SimConfig(**base)
    pts = _sweep_params(sim, SWEEP_GRID)
    G = len(pts)
    # a short grid first, untimed: its capture and first launches at G·W rows
    sim.simulate_sweep(wl, mesh, sim.SimConfig(**{**base, "max_ticks": 20}), pts)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    cores = sim.core_count()
    t0 = time.perf_counter()
    grid = sim.simulate_sweep(wl, mesh, cfg, pts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    if sim.core_count() - cores != 1:
        raise SystemExit(f"sweep: {sim.core_count() - cores} core calls for one grid")
    if counts["steal_compact"] == 0:
        raise SystemExit("sweep: steal_compact was never launched")
    events = [r.events for r in grid]
    print(f"[sweep] W={W_MAIN} x {G} points (G·W = {G * W_MAIN}): wall {wall:.3f} s, "
          f"one core call; per-point events {min(events)}..{max(events)} "
          f"(the loop's iterations: {max(events)}, then the masked ones up to "
          f"the done-flag read); launches {counts}")
    # the port's per-point runs on the card
    walls = []
    for (s, tau, seed), p, r in zip(SWEEP_GRID, pts, grid):
        one_cfg = sim.SimConfig(**{**base, "strategy": sim.stealing.Strategy(s),
                                   "hop_ticks": tau, "seed": seed})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one = sim.simulate(wl, mesh, one_cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        _assert_equal(np, one, r, what=f"sweep point ({s}, {tau}, {seed}) vs its own run")
        print(f"[sweep] ({s}, tau {tau}, seed {seed}): ticks={r.ticks} "
              f"events={r.events} nodes={r.nodes} overflow={r.overflow} "
              f"per-point run {walls[-1]:.3f} s, equal field for field")
    k = SWEEP_GRID.index(("neighbor", 5, 0))
    _assert_equal(np, main_run, grid[k], what="sweep (neighbor, 5, 0) vs [main]")
    if grid[k].events != MAIN_EVENTS[64]:
        raise SystemExit(f"sweep (neighbor, 5, 0): {grid[k].events} events")
    ticks = sum(r.ticks for r in grid)
    print(f"[sweep] every point equals its own run; (neighbor, 5, 0) equals [main] "
          f"({grid[k].events} events). Grid {wall:.3f} s against the {G} per-point "
          f"runs' {sum(walls):.3f} s: ratio {sum(walls) / wall:.3f}; "
          f"sum of ticks / grid wall = {ticks / wall:.2f} ticks/s "
          f"({ticks / sum(walls):.2f} sequentially); "
          f"{wall / max(events) * 1e3:.3f} ms a loop iteration")
    # where the time goes: a 300-tick window of the grid, timed, then profiled
    win = sim.SimConfig(**{**base, "max_ticks": 300})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters = max(r.events for r in sim.simulate_sweep(wl, mesh, win, pts))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy, n_dev, by_name = _profile(torch, lambda: sim.simulate_sweep(wl, mesh, win, pts))
    hits = [v for name, v in by_name.items() if "steal_compact_kernel" in name]
    k_ms, k_n = sum(ms for ms, _ in hits), sum(c for _, c in hits)
    if k_n == 0:
        raise SystemExit("profile of the sweep: no steal_compact kernel seen")
    print(f"[profile] sweep W={W_MAIN} x {G}, 300 ticks, {iters} loop iterations: "
          f"device busy {busy:.3f} ms of {wall_ms:.3f} ms wall (busy share "
          f"{busy / wall_ms:.4f}); {n_dev} device activities = {n_dev / iters:.1f} "
          f"per iteration; steal_compact {k_n}x, {k_ms / k_n * 1e3:.3f} us each "
          f"at {G * W_MAIN} rows")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
        print(f"[profile]   {ms:9.3f} ms {cnt:7d}x {name[:90]}")
    # the staged backend: deque_apply at G·W rows, equal to the loop sweep
    six = [i for i, (_, _, seed) in enumerate(SWEEP_GRID) if seed == 0]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    staged = sim.simulate_sweep(wl, mesh, sim.SimConfig(**base, deque_backend="staged"),
                                [pts[i] for i in six])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    staged_counts = dict(ops.LAUNCHES)
    if staged_counts["deque_apply"] == 0:
        raise SystemExit("staged sweep: deque_apply was never launched")
    for i, r in zip(six, staged):
        _assert_equal(np, grid[i], r, what=f"staged sweep point {SWEEP_GRID[i]}")
    it = max(r.events for r in staged)
    print(f"[sweep] staged backend, {len(six)} points (seed 0; G·W = "
          f"{len(six) * W_MAIN}): {dt:.3f} s, {it} loop iterations, "
          f"{dt / it * 1e3:.3f} ms an iteration; every point equal to the loop "
          f"sweep's; launches {staged_counts}")
    return ({"steal_compact": counts["steal_compact"],
             "deque_apply": staged_counts["deque_apply"]}, k_ms / k_n)


# the reference's crossover at BENCH_crossover.json's settings (sizes 16, 25,
# 36, 64; tau 2, 5; 3 runs; FIB n=26 cutoff=12 max_leaf_cost=16; capacity
# 2048; 5,000,000 ticks): each point's ticks, one per seed, from
# `benchmarks.sweep.crossover(..., rtt_hists=False)` of the JAX package on a
# CPU. The checked-in BENCH_crossover.json holds other ticks at every point
# (an artifact older than the reference as it stands)
CROSSOVER_TICKS = {
    (16, 2, "neighbor"): [1001, 1023, 1008], (16, 2, "global"): [1077, 1076, 1074],
    (16, 5, "neighbor"): [1191, 1094, 1179], (16, 5, "global"): [1382, 1296, 1259],
    (25, 2, "neighbor"): [738, 764, 781], (25, 2, "global"): [846, 781, 782],
    (25, 5, "neighbor"): [868, 872, 916], (25, 5, "global"): [1194, 1249, 1325],
    (36, 2, "neighbor"): [755, 703, 660], (36, 2, "global"): [713, 681, 748],
    (36, 5, "neighbor"): [1016, 899, 925], (36, 5, "global"): [989, 1021, 1272],
    (64, 2, "neighbor"): [639, 727, 703], (64, 2, "global"): [621, 773, 600],
    (64, 5, "neighbor"): [808, 954, 817], (64, 5, "global"): [975, 1100, 1164]}
# the reference's RTT rows at the same settings (`benchmarks.sweep._measure_rtt`:
# one traced run per strategy at N=64, tau 5): (resolved attempts, granted,
# measured mean round trip in ticks); NEIGHBOR's is exactly 2·tau
RTT_PINS = {"neighbor": (4139, 265, 10.0), "global": (946, 157, 51.575052854122625)}


def phase_crossover(torch, ops):
    """The port's crossover benchmark at BENCH_crossover.json's settings, one
    grid a size on the card, with the flight recorder's RTT rows; every
    point's ticks must equal the reference's (CROSSOVER_TICKS), and every RTT
    row's resolved attempts, grants and mean round trip (RTT_PINS). Writes
    the document to chiprun_out/BENCH_crossover_torch.json beside this
    script. Returns steal_compact's launches."""
    from repro_torch.core import jsonio
    from repro_torch.benchmarks import sweep
    from repro_torch.core import tasks

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    doc = sweep.crossover((16, 25, 36, 64), taus=(2, 5), runs=3,
                          workload=tasks.FibWorkload(n=26, cutoff=12, max_leaf_cost=16),
                          capacity=2048, max_ticks=5_000_000, rtt_hists=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rtt = {h["strategy"]: (h["resolved_attempts"], h["granted"], h["measured_mean_rtt"])
           for h in doc["rtt"]}
    if rtt != RTT_PINS or rtt["neighbor"][2] != 2 * 5:
        raise SystemExit(f"crossover: RTT rows {rtt}, the reference's {RTT_PINS}")
    out = Path(__file__).resolve().parent / "chiprun_out" / "BENCH_crossover_torch.json"
    out.parent.mkdir(exist_ok=True)
    jsonio.write(out, doc, indent=2)
    launches = ops.LAUNCHES["steal_compact"]
    got = {(p["N"], p["tau"], p["strategy"]): p["ticks"] for p in doc["points"]}
    if got != CROSSOVER_TICKS:
        bad = sorted(k for k in CROSSOVER_TICKS if got.get(k) != CROSSOVER_TICKS[k])
        raise SystemExit(f"crossover: ticks differ from the reference's at {bad}: "
                         f"{[(k, got.get(k), CROSSOVER_TICKS[k]) for k in bad]}")
    if doc["traces_per_size"] != {str(n): 1 for n in (16, 25, 36, 64)} or not launches:
        raise SystemExit(f"crossover: core calls {doc['traces_per_size']}, "
                         f"steal_compact launches {launches}")
    print(f"[crossover] sizes 16, 25, 36, 64 x tau 2, 5 x 3 seeds x 2 strategies, one "
          f"core call a size: {wall:.3f} s; every point's ticks equal the "
          f"reference's; ratios neighbor/global "
          + ", ".join(f"N={c['N']} tau={c['tau']}: {c['ratio_neighbor_over_global']:.4f}"
                      for c in doc["crossover"])
          + f"; steal_compact launches {launches}")
    for h in doc["rtt"]:
        print(f"[crossover] rtt {h['strategy']} N={h['num_workers']} tau={h['tau']:g}: "
              f"resolved {h['resolved_attempts']}, granted {h['granted']}, mean round "
              f"trip {h['measured_mean_rtt']!r} ticks (analytic {h['analytic_rtt']!r}), "
              f"p {h['p_success']:.4f} = the reference's")
    print(f"[crossover] wrote {out}")
    return launches


# the fault scenarios: examples/constellation_sim.py's constellation
# settings (a 40-tick warning, 15% of the workers in eclipse, 0.5% lost to
# radiation, 1% degraded to speed 3, a checkpoint every 80 ticks), the
# eclipse's orbit cut from 1500 ticks to a 500-tick period so that its second
# cycle falls inside the 1500-tick run; worker counts at W = 4096 and at the
# drained W = 100 (eclipse, radiation, stragglers)
FAULT_WARN, FAULT_PERIOD, FAULT_SLEEP, FAULT_CKPT, FAULT_SPEED = 40, 500, 175, 80, 3
FAULT_COUNTS = {4096: (614, 20, 41), 100: (15, 2, 1)}
# the drained W=100 runs' fault-free ticks (NEIGHBOR, tau 5, capacity 64, FIB
# n=34 cutoff=18): deaths fall in its first half, before the run drains
DRAINED_TICKS = 4769


def fault_schedules(np, W: int, first_half: int | None = None) -> dict:
    """The three fault scenarios' schedules for W workers, made with numpy
    from seed 0: disjoint worker sets for the eclipse (periodic: first death
    uniform in [50, 500), wake 175 ticks later, period 500), radiation (one
    death uniform in [100, 1400), or in [100, first_half) for a drained run)
    and stragglers (speed 3). Returns {name: simulate's schedule kwargs}."""
    n_ecl, n_rad, n_str = FAULT_COUNTS[W]
    rs = np.random.default_rng(0)
    perm = rs.permutation(W)
    ecl, rad = perm[:n_ecl], perm[n_ecl:n_ecl + n_rad]
    slow = perm[n_ecl + n_rad:n_ecl + n_rad + n_str]
    never = np.full(W, -1, np.int32)
    ft, wt, fp = never.copy(), never.copy(), never.copy()
    ft[ecl] = rs.integers(50, min(FAULT_PERIOD, first_half or FAULT_PERIOD), n_ecl)
    wt[ecl] = ft[ecl] + FAULT_SLEEP
    fp[ecl] = FAULT_PERIOD
    rft = never.copy()
    rft[rad] = rs.integers(100, first_half or 1400, n_rad)
    speed = np.ones(W, np.int32)
    speed[slow] = FAULT_SPEED
    return {"eclipse": {"fail_time": ft, "wake_time": wt, "fail_period": fp},
            "radiation": {"fail_time": rft},
            "stragglers": {"speed": speed}}


# the fault scenarios' SimConfig fields beyond the run's base, by label
FAULT_RUNS = {
    "eclipse": ("eclipse", {"preshed": True, "warn_ticks": FAULT_WARN}),
    "radiation/tc": ("radiation", {"recovery": "tc", "ckpt_interval": FAULT_CKPT}),
    "radiation/supervision": ("radiation", {"recovery": "supervision"}),
    "radiation/none": ("radiation", {}),
    "stragglers": ("stragglers", {}),
}
# the runs that also go through the staged backend, the famine path off and
# tick mode at W=4096 (each must equal its leap/loop run, `events` aside)
FAULT_MODES = (("leap/staged", {"deque_backend": "staged"}),
               ("leap/loop fb=0", {"famine_batch": 0}),
               ("tick/loop", {"step_mode": "tick"}))
# the reference's (`repro.core.simulator.simulate`, JAX on a CPU) drained
# W=100 runs of each scenario (`fault_schedules(np, 100, DRAINED_TICKS // 2)`,
# NEIGHBOR, tau 5, capacity 64, famine_batch 64, FIB n=34 cutoff=18):
# (result, ticks, events). TC and pre-shed are exact (5702887); supervision
# over-counts the subtrees re-stolen from its dead thieves
FAULT_PINS = {"eclipse": (5702887, 6965, 5393),
              "radiation/tc": (5702887, 6347, 4888),
              "radiation/supervision": (8713236, 8840, 6969),
              "radiation/none": (5188658, 4620, 3846),
              "stragglers": (5702887, 5007, 4291)}


def _fault_cfg(sim, base: dict, extra: dict, **more):
    f = {**base, **extra, **more}
    if "recovery" in f:
        f["recovery"] = sim.Recovery(f["recovery"])
    return sim.SimConfig(**f)


def _faults_cpu_run(label: str):
    """The port's CPU run of one drained W=100 fault scenario (in a worker
    process, beside the card runs of the main process)."""
    import numpy as np
    import torch

    from repro_torch.core import simulator as sim
    from repro_torch.core import tasks
    from repro_torch.core import topology as topo

    torch.set_num_threads(1)
    scen, extra = FAULT_RUNS[label]
    t0 = time.perf_counter()
    r = sim.simulate(tasks.FibWorkload(n=34, cutoff=18), topo.MeshTopology.square(100),
                     _fault_cfg(sim, _drained_base(sim), extra), device="cpu",
                     **fault_schedules(np, 100, DRAINED_TICKS // 2)[scen])
    return r, time.perf_counter() - t0


def _drained_base(sim):
    return dict(strategy=sim.stealing.Strategy.NEIGHBOR, hop_ticks=5, capacity=64)


def phase_faults(torch, np, sim, topo, tasks, ops, ref, deque, main_run, main_ms):
    """The fault model on the card. At W=4096 (the main path's
    configuration) each scenario runs leap/loop; eclipse and radiation/TC
    also staged, with the famine path off and in tick mode, each equal to
    the leap/loop run (`events` aside); ms/event against `[main]`'s;
    `deque_apply` at the TC push-log width; a profiled 300-tick TC window.
    At W=100, drained: each scenario card == CPU, equal to the reference's
    pinned (result, ticks, events), TC and pre-shed exact. Then the
    radiation schedule under TC as one 6-point sweep (checkpoint interval
    0, 40, 80 x NEIGHBOR, GLOBAL), every point equal to its own run.
    Returns (launches by kernel, deque_apply at the TC width)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    # the drained runs' CPU side starts first, in worker processes beside
    # everything the card runs in this phase
    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(len(FAULT_RUNS),
                               mp_context=multiprocessing.get_context("spawn"))
    cpu = {label: pool.submit(_faults_cpu_run, label) for label in FAULT_RUNS}
    try:
        out = _phase_faults(torch, np, sim, topo, tasks, ops, ref, deque, main_run,
                            main_ms, cpu)
    finally:
        pool.shutdown(cancel_futures=True)
    print(f"[faults] phase {time.perf_counter() - t0:.3f} s")
    return out


def _phase_faults(torch, np, sim, topo, tasks, ops, ref, deque, main_run, main_ms, cpu):
    mesh, wl, base = _main_setup(sim, topo, tasks)
    sched = fault_schedules(np, W_MAIN)
    n_ecl, n_rad, n_str = FAULT_COUNTS[W_MAIN]
    print(f"[faults] W={W_MAIN}, the [main] configuration, cut at {base['max_ticks']} "
          f"ticks; schedules from numpy seed 0: eclipse {n_ecl} workers (15%), "
          f"first death uniform in [50, {FAULT_PERIOD}), wake {FAULT_SLEEP} ticks "
          f"later, period {FAULT_PERIOD} (examples/constellation_sim.py's 1500-tick "
          f"orbit cut to {FAULT_PERIOD} so that second-cycle deaths and wakes fall "
          f"inside the run), pre-shed with a {FAULT_WARN}-tick warning; radiation "
          f"{n_rad} workers (0.5%) die once at ticks uniform in [100, 1400) under "
          f"TC (checkpoint every {FAULT_CKPT}), SUPERVISION and NONE; stragglers "
          f"{n_str} workers (1%) at speed {FAULT_SPEED}")
    launches = {"steal_compact": 0, "deque_apply": 0}

    def run(label, cfg, kw, mesh_=mesh, wl_=wl):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = sim.simulate(wl_, mesh_, cfg, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: ops.LAUNCHES[k] for k in ("steal_compact", "deque_apply")}
        kernel = "deque_apply" if cfg.deque_backend == "staged" else "steal_compact"
        if counts[kernel] == 0:
            raise SystemExit(f"[faults] {label}: kernel {kernel} was never launched")
        for k in launches:
            launches[k] += counts[k]
        return r, dt, counts

    # a short run of each backend under TC first, untimed (capture, first use)
    for backend in ("loop", "staged"):
        sim.simulate(wl, mesh, _fault_cfg(sim, {**base, "max_ticks": 20},
                                          FAULT_RUNS["radiation/tc"][1],
                                          deque_backend=backend), **sched["radiation"])
    firsts = {}
    for label, (scen, extra) in FAULT_RUNS.items():
        modes = (("leap/loop", {}),) + (FAULT_MODES if label in ("eclipse", "radiation/tc")
                                        else ())
        for mode, mextra in modes:
            r, dt, counts = run(f"{label} {mode}", _fault_cfg(sim, base, extra, **mextra),
                                sched[scen])
            first = firsts.setdefault(label, r)
            _assert_equal(np, first, r, skip=("events",),
                          what=f"[faults] {label} leap/loop vs {mode}")
            if mode == "tick/loop" and r.events != r.ticks:
                raise SystemExit(f"[faults] {label} tick: {r.events} events")
            print(f"[faults] {label} {mode}: ticks={r.ticks} events={r.events} "
                  f"wall={dt:.3f} s ms/event={dt / r.events * 1e3:.3f} "
                  f"({dt / r.events * 1e3 / main_ms:.2f}x [main]'s {main_ms:.3f}) "
                  f"nodes={r.nodes} overflow={r.overflow} "
                  f"ckpt_bytes={r.ckpt_bytes:.0f} launches={counts}")
    for label, r in firsts.items():
        if r.ticks != base["max_ticks"] or r.nodes <= 0:
            raise SystemExit(f"[faults] {label}: ticks {r.ticks} nodes {r.nodes}")
    print(f"[faults] W={W_MAIN}: every mode equal to its leap/loop run, field for "
          f"field but events; the closed [main] run took {main_run.events} events")

    # deque_apply at the push-log width of a TC or pre-shed tick
    L = tasks.EXPAND_K + 1 + CAP_MAIN + ref.GRANT_WIDTH + 2
    rs = np.random.default_rng(20261017)
    buf = torch.as_tensor(rs.integers(-2**31, 2**31 - 1, (W_MAIN, CAP_MAIN, 4),
                                      dtype=np.int64).astype(np.int32), device="cuda")
    bot = torch.as_tensor(rs.integers(0, CAP_MAIN, W_MAIN).astype(np.int32), device="cuda")
    size = torch.as_tensor(rs.integers(0, CAP_MAIN + 1, W_MAIN).astype(np.int32),
                           device="cuda")
    da = _deque_apply_at(torch, np, ops, ref, deque, rs, buf, bot, size, L)
    da["lanes"] = L
    print(f"[faults] deque_apply at {W_MAIN} rows, C={CAP_MAIN}, L={L} lanes (the "
          f"TC / pre-shed push log): exact, gated and n = 0 rows bit for bit; "
          f"device per launch: kernel {da['ms']:.6f} ms, plain "
          f"{da['plain_ms']:.6f} ms, library {da['library_ms']:.6f} ms (in-place "
          f"index_put_), bound {da['bound_ms']:.6f} ms ({da['bound_by']}, "
          f"{da['bytes']} bytes: {da['live']} live lanes, {da['winners']} "
          f"winners); eager wrapper call {da['call_ms']:.6f} ms; medians of three "
          f"in turns, kernel {da['turns']['kernel']} ms, library "
          f"{da['turns']['library']} ms")

    # where the time goes under TC: a 300-tick window, timed, then profiled
    scen, extra = FAULT_RUNS["radiation/tc"]
    win = _fault_cfg(sim, {**base, "max_ticks": 300}, extra)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = sim.simulate(wl, mesh, win, **sched[scen]).events
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy, n_dev, by_name = _profile(torch, lambda: sim.simulate(wl, mesh, win, **sched[scen]))
    print(f"[profile] faults radiation/tc W={W_MAIN}, 300 ticks, {ev} events: device "
          f"busy {busy:.3f} ms of {wall_ms:.3f} ms wall (busy share "
          f"{busy / wall_ms:.4f}); {n_dev} device activities = {n_dev / ev:.1f} per event")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[profile]   {ms:9.3f} ms {cnt:7d}x {name[:90]}")

    # drained W=100: card == CPU (worker processes), the reference's pins
    mesh100 = topo.MeshTopology.square(100)
    wl100 = tasks.FibWorkload(n=34, cutoff=18)
    sched100 = fault_schedules(np, 100, DRAINED_TICKS // 2)
    for label, (scen, extra) in FAULT_RUNS.items():
        rg, dt, counts = run(f"W=100 {label}",
                             _fault_cfg(sim, _drained_base(sim), extra),
                             sched100[scen], mesh100, wl100)
        got = (rg.result, rg.ticks, rg.events)
        if got != FAULT_PINS[label]:
            raise SystemExit(f"[faults] W=100 {label}: (result, ticks, events) "
                             f"{got}, the reference's {FAULT_PINS[label]}")
        exact = rg.result == wl100.expected_result()
        if label in ("eclipse", "radiation/tc") and not exact:
            raise SystemExit(f"[faults] W=100 {label}: result {rg.result} not exact")
        rc, dt_c = cpu[label].result()
        _assert_equal(np, rg, rc, what=f"[faults] W=100 {label} card vs cpu")
        print(f"[faults] W=100 {label}: result={rg.result} (exact: {exact}) "
              f"ticks={rg.ticks} events={rg.events} = the reference's; card "
              f"{dt:.3f} s ({dt / rg.events * 1e3:.3f} ms/event), cpu {dt_c:.3f} s "
              f"in a worker process, card == cpu; launches={counts}")

    # the radiation schedule under TC across a grid
    code = sim.stealing.strategy_code
    grid_pts = [(ck, s) for ck in (0, 40, FAULT_CKPT) for s in ("neighbor", "global")]
    pts = [sim.SimParams(strategy=code(s), hop_ticks=base["hop_ticks"], ckpt_interval=ck)
           for ck, s in grid_pts]
    tc_cfg = _fault_cfg(sim, base, {"recovery": "tc"})
    sim.simulate_sweep(wl, mesh, _fault_cfg(sim, {**base, "max_ticks": 20},
                                            {"recovery": "tc"}), pts, **sched[scen])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    grid = sim.simulate_sweep(wl, mesh, tc_cfg, pts, **sched[scen])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["steal_compact"] += ops.LAUNCHES["steal_compact"]
    walls = []
    for (ck, s), r in zip(grid_pts, grid):
        one, dt, _ = run(f"grid point {s} ckpt {ck}",
                         _fault_cfg(sim, base, {"recovery": "tc", "ckpt_interval": ck},
                                    strategy=sim.stealing.Strategy(s)), sched[scen])
        walls.append(dt)
        _assert_equal(np, one, r, what=f"[faults] TC grid point ({s}, ckpt {ck})")
        print(f"[faults] TC grid ({s}, ckpt {ck}): ticks={r.ticks} events={r.events} "
              f"nodes={r.nodes} ckpt_bytes={r.ckpt_bytes:.0f}; its own run "
              f"{dt:.3f} s, equal field for field")
    print(f"[faults] TC grid, {len(pts)} points at W={W_MAIN} (G·W = "
          f"{len(pts) * W_MAIN}): wall {wall:.3f} s against the per-point runs' "
          f"{sum(walls):.3f} s (ratio {sum(walls) / wall:.3f}); every point equal "
          f"to its own run")
    return launches, da


# the [linkstate] phase: the reference's benchmarks/bench_sim_throughput.py
# `_dynamic_constellation` scenario (a wraparound torus, an orbit of 16
# ticks a plane, 35% eclipse, 10% of the satellites battery-limited and
# sleeping in it with a warning, seam handovers dark 10% of their 16-tick
# cycle), at W=4096 over 2 orbits (1024 ticks each) under the [main]
# workload cut at 1500 ticks, routing "auto" (sparse at this size)
LINK_ORBITS = {4096: 2, 100: 10}
LINK_TAU = 5
# the W=4096 runs: label, strategy, SimConfig fields beyond the run's base;
# each NEIGHBOR mode must equal NEIGHBOR's leap/loop run, `events` aside
LINK_RUNS = (("neighbor leap/loop", "neighbor", {}),
             ("adaptive leap/loop", "adaptive", {}),
             ("global leap/loop", "global", {}),
             ("neighbor leap/staged", "neighbor", {"deque_backend": "staged"}),
             ("neighbor leap/loop fb=0", "neighbor", {"famine_batch": 0}),
             ("neighbor tick/loop", "neighbor", {"step_mode": "tick"}))
# the drained W=100 runs: the same recipe on a 10x10 torus over 10 orbits of
# 160 ticks (the horizon covers every run), FIB n=26 cutoff=14 (it drains
# within ~1,500 ticks), capacity 64, the default famine batch, pre-shed
# with the recipe's 20-tick warning; routing by label (sparse: prebuilt
# tables with 5x5 patches, so landmark prices cross patches). The
# reference's (`repro.core.simulator.simulate`, JAX on a CPU) (result,
# ticks, events); every run is exact (121393)
LINK_FIB100 = (26, 14)
LINK_PINS = {"neighbor/dense": (121393, 687, 591),
             "global/dense": (121393, 1505, 1278),
             "neighbor/sparse 5x5": (121393, 1301, 906)}


def _link_scenario(np, W: int):
    """The dynamic constellation at W workers: (constellation, schedule,
    simulate's schedule kwargs: the predictable deaths, wakes and periods)."""
    from repro_torch.benchmarks.common import dynamic_constellation

    con, sched, _ = dynamic_constellation(W, LINK_TAU, LINK_ORBITS[W])
    kw = {"fail_time": np.where(sched.predictable, sched.fail_time, -1).astype(np.int32),
          "wake_time": sched.wake_time, "fail_period": sched.fail_period}
    return con, sched, kw


def _link100(sim, np, label: str, device: str):
    """One drained W=100 [linkstate] run on `device`: (result, wall s)."""
    from repro_torch.core import linkstate as lstate
    from repro_torch.core import tasks

    con, sched, kw = _link_scenario(np, 100)
    strategy, routing = label.split("/")
    ls = sched.linkstate
    if routing.startswith("sparse"):
        ls, _ = lstate.build_tables(ls, con.mesh, routing="sparse", patch=(5, 5),
                                    device=device)
        routing = "sparse"
    cfg = sim.SimConfig(strategy=sim.stealing.Strategy(strategy), hop_ticks=LINK_TAU,
                        capacity=CAP_MAIN, preshed=True, warn_ticks=con.cfg.warn_ticks)
    t0 = time.perf_counter()
    r = sim.simulate(tasks.FibWorkload(n=LINK_FIB100[0], cutoff=LINK_FIB100[1]), con.mesh,
                     cfg, linkstate=ls, routing_backend=routing, device=device, **kw)
    return r, time.perf_counter() - t0


def _linkstate_cpu_run(label: str):
    """The port's CPU run of one drained W=100 [linkstate] configuration (in
    a worker process, beside the card runs of the main process)."""
    import numpy as np
    import torch

    from repro_torch.core import simulator as sim

    torch.set_num_threads(1)
    return _link100(sim, np, label, "cpu")


def phase_linkstate(torch, np, sim, ops, main_ms):
    """Time-varying link state on the card. At W=4096: the dynamic
    constellation's tables built once (host seconds, build report, resident
    bytes), then NEIGHBOR, ADAPTIVE and GLOBAL leap/loop over them, and
    NEIGHBOR staged, with the famine path off and in tick mode, each equal
    to NEIGHBOR's leap/loop run (`events` aside); ms/event against
    `[main]`'s; a profiled 300-tick window. At W=100, drained: each run
    equal to the reference's pinned (result, ticks, events), exact, and
    card == CPU. Returns (the launches by kernel, the W=4096 runs' context:
    the tables, the schedule's kwargs, mesh, base config and the runs by
    label)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(len(LINK_PINS),
                               mp_context=multiprocessing.get_context("spawn"))
    cpu = {label: pool.submit(_linkstate_cpu_run, label) for label in LINK_PINS}
    try:
        out = _phase_linkstate(torch, np, sim, ops, main_ms, cpu)
    finally:
        pool.shutdown(cancel_futures=True)
    print(f"[linkstate] phase {time.perf_counter() - t0:.3f} s")
    return out


def _phase_linkstate(torch, np, sim, ops, main_ms, cpu):
    import dataclasses

    from repro_torch.core import linkstate as lstate
    from repro_torch.core import tasks

    con, sched, kw = _link_scenario(np, W_MAIN)
    mesh = con.mesh
    wl = tasks.FibWorkload(n=48, cutoff=28, max_leaf_cost=2048)
    base = dict(hop_ticks=LINK_TAU, capacity=CAP_MAIN, max_ticks=1500, preshed=True,
                warn_ticks=con.cfg.warn_ticks)
    ccfg = con.cfg
    n_sleep = int((kw["fail_time"] >= 0).sum())
    print(f"[linkstate] W={W_MAIN}: a {ccfg.planes}x{ccfg.sats_per_plane} wraparound "
          f"torus, orbit {ccfg.orbit_ticks} ticks x {LINK_ORBITS[W_MAIN]}, tau_base "
          f"{ccfg.tau_base}, inter-plane amplitude {ccfg.interplane_amp}, eclipse "
          f"{ccfg.eclipse_fraction}, {n_sleep} battery-limited sleepers (periodic), "
          f"seam outage {ccfg.seam_outage_frac} of a {con.handover_cycle()}-tick "
          f"handover cycle, warn {ccfg.warn_ticks}; the [main] workload cut at "
          f"{base['max_ticks']} ticks")
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    tbl, stats = lstate.build_tables(sched.linkstate, mesh, routing="auto", device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_b
    print(f"[linkstate] tables built in {build_s:.3f} s (host, to the card): "
          + " ".join(f"{k}={v}" for k, v in dataclasses.asdict(stats).items()))
    print(f"[linkstate] routing tables {lstate.table_bytes(tbl)} bytes as the "
          f"reference counts them (landmarks at 2 bytes); resident on the card "
          f"{lstate.resident_bytes(tbl)} bytes, every table of the schedule "
          f"(landmarks held in int32)")
    launches = {"steal_compact": 0, "deque_apply": 0}

    def run(label, cfg, ls, mesh_=mesh, wl_=wl, kw_=kw):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        r = sim.simulate(wl_, mesh_, cfg, linkstate=ls, **kw_)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        counts = {k: ops.LAUNCHES[k] for k in launches}
        kernel = "deque_apply" if cfg.deque_backend == "staged" else "steal_compact"
        if counts[kernel] == 0:
            raise SystemExit(f"[linkstate] {label}: kernel {kernel} was never launched")
        for k in launches:
            launches[k] += counts[k]
        return r, dt, counts

    def cfg_of(strategy, extra, **more):
        return sim.SimConfig(**{**base, **extra, **more},
                             strategy=sim.stealing.Strategy(strategy))

    # a short run of each backend first, untimed (capture, first use)
    for backend in ("loop", "staged"):
        sim.simulate(wl, mesh, cfg_of("neighbor", {"deque_backend": backend},
                                      max_ticks=20), linkstate=tbl, **kw)
    runs = {}
    for label, strategy, extra in LINK_RUNS:
        r, dt, counts = run(label, cfg_of(strategy, extra), tbl)
        runs[label] = r
        if r.ticks != base["max_ticks"] or r.nodes <= 0:
            raise SystemExit(f"[linkstate] {label}: ticks {r.ticks} nodes {r.nodes}")
        if label.startswith("neighbor") and label != "neighbor leap/loop":
            _assert_equal(np, runs["neighbor leap/loop"], r, skip=("events",),
                          what=f"[linkstate] neighbor leap/loop vs {label}")
        if "tick" in label and r.events != r.ticks:
            raise SystemExit(f"[linkstate] {label}: {r.events} events")
        print(f"[linkstate] W={W_MAIN} {label}: ticks={r.ticks} events={r.events} "
              f"wall={dt:.3f} s ms/event={dt / r.events * 1e3:.3f} "
              f"({dt / r.events * 1e3 / main_ms:.2f}x [main]'s {main_ms:.3f}) "
              f"nodes={r.nodes} attempts={r.attempts} successes={r.successes} "
              f"overflow={r.overflow} launches={counts}")
    print("[linkstate] NEIGHBOR staged, famine path off and tick mode: each equal to "
          "its leap/loop run, field for field but events")
    # where the time goes: a 300-tick window, timed, then profiled
    win = cfg_of("neighbor", {}, max_ticks=300)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev = sim.simulate(wl, mesh, win, linkstate=tbl, **kw).events
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
    busy, n_dev, by_name = _profile(
        torch, lambda: sim.simulate(wl, mesh, win, linkstate=tbl, **kw))
    print(f"[profile] linkstate neighbor leap/loop W={W_MAIN}, 300 ticks, {ev} events: "
          f"device busy {busy:.3f} ms of {wall_ms:.3f} ms wall (busy share "
          f"{busy / wall_ms:.4f}); {n_dev} device activities = {n_dev / ev:.1f} per event")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"[profile]   {ms:9.3f} ms {cnt:7d}x {name[:90]}")

    # drained W=100: the reference's pins, exact, card == CPU
    for label, pin in LINK_PINS.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rg, dt = _link100(sim, np, label, "cuda")
        torch.cuda.synchronize()
        counts = {k: ops.LAUNCHES[k] for k in launches}
        if counts["steal_compact"] == 0:
            raise SystemExit(f"[linkstate] W=100 {label}: steal_compact never launched")
        for k in launches:
            launches[k] += counts[k]
        got = (rg.result, rg.ticks, rg.events)
        if got != pin:
            raise SystemExit(f"[linkstate] W=100 {label}: (result, ticks, events) "
                             f"{got}, the reference's {pin}")
        rc, dt_c = cpu[label].result()
        _assert_equal(np, rg, rc, what=f"[linkstate] W=100 {label} card vs cpu")
        print(f"[linkstate] W=100 {label}: result={rg.result} (exact) ticks={rg.ticks} "
              f"events={rg.events} = the reference's; card {dt:.3f} s "
              f"({dt / rg.events * 1e3:.3f} ms/event), cpu {dt_c:.3f} s in a worker "
              f"process, card == cpu; launches={counts}")
    return launches, {"tbl": tbl, "kw": kw, "mesh": mesh, "base": base, "runs": runs,
                      "con": con}


# the [trace] phase's partitioned link state at W=100: the 5x5 corner of the
# 10x10 mesh cut off (every link across its edge down) for ticks
# [TRACE_CUT[0], TRACE_CUT[1]), uniform tau 5: GLOBAL's thieves draw across
# the cut in famine windows, which the replay re-emits as EV_NO_LIVE_VICTIM
TRACE_CUT = (300, 2000)


def trace_partition(np, lstate, mesh):
    """The partitioned schedule on `mesh` (a 10x10 `MeshTopology`) as
    `lstate.LinkStateSchedule` (the port's module, or any with its
    constructor)."""
    W = mesh.num_workers
    up = np.ones((3, W, 4), bool)
    nbr = mesh.neighbor_table
    corner = (mesh.coords[:, 0] < 5) & (mesh.coords[:, 1] < 5)
    for w in range(W):
        for d in range(4):
            if nbr[w, d] >= 0 and corner[w] != corner[nbr[w, d]]:
                up[1, w, d] = False
    return lstate.LinkStateSchedule(
        np.asarray((0,) + TRACE_CUT, np.int32), np.full((3, W, 4), LINK_TAU, np.int32),
        up, np.ones((3, W), np.int32)).validate(mesh)


# the [trace] phase: the flight recorder (`repro_torch.core.tracing`) on the
# main path. Recorder shapes (ring rows, bins, bin ticks): the W=4096 runs
# emit 670,905 events over 1500 ticks (64 bins of 32 ticks: 32·4096·64 <
# 2^31, so no channel wraps), the dynamic constellation's fewer than 2^21;
# the drained W=100 runs fewer than 2^16 over fewer than 16,384 ticks
TRACE_MAIN = (1 << 20, 64, 32)
TRACE_LINK = (1 << 21, 64, 32)
TRACE_100 = (1 << 16, 256, 64)
# the main path's traced runs: label, SimConfig fields beyond the base
TRACE_MODES = (("leap/loop", {}),
               ("leap/staged", {"deque_backend": "staged"}),
               ("leap/loop fb=0", {"famine_batch": 0}),
               ("tick/staged", {"step_mode": "tick", "deque_backend": "staged"}))
# the reference's (`repro.core.simulator.simulate` with `repro.core.tracing`,
# JAX on a CPU) traced runs: (events, emitted, sha256 of the written ring as
# little-endian int32). The main path at famine batch 64 and 0 (the bin
# boundaries add iterations: 287 and 667 untraced); the drained W=100 runs
# (FIB n=34 cutoff=18, tau 5, capacity 64, famine batch 64): the three
# strategies, GLOBAL on the partitioned schedule (`trace_partition`) and the
# radiation schedule under TC (checkpoint every 80)
TRACE_RING_MAIN = "4ea8f91ebfcd6ecd77e5656b4c8f3b9f5ee0a2a28f83df28ffa3f37e41fa9e1e"
TRACE_PINS = {
    "main": (309, 670905, TRACE_RING_MAIN),
    "main fb=0": (684, 670905, TRACE_RING_MAIN),
    "neighbor": (4115, 37003,
                 "e68a029c61f7d3803b9102adfa03538c0a4204ae591496559b6e5cee3cb6fc8f"),
    "global": (2795, 2791,
               "c52609cf269194b2b82d51ca77550ce83ae565dfe8093ca1c987fd1c409f4e81"),
    "adaptive": (3998, 21111,
                 "e70b72efee6f93b789f17faa14f14291109a1c0aad723f14b62a468a8e5259d7"),
    "global/partition": (3205, 8155,
                         "fbb9e814bbee961ae99dab4f002cfcca590e59a2750185345a9c093f7e8f6031"),
    "radiation/tc": (4897, 53073,
                     "da9bfa9d6232b0874efe694030aedd33c941e5edf04cec74e1dcef0a7dc6599a"),
}
# the drained W=100 runs' backends (each also on the CPU); on the card the
# three strategies run as one 3-point sweep
TRACE_100_BACKEND = {"neighbor": "staged", "global": "staged", "adaptive": "staged",
                     "global/partition": "loop", "radiation/tc": "staged"}
TRACE_100_SWEEP = ("neighbor", "global", "adaptive")
_UNTRACED = ("events", "trace", "timeseries", "sojourn")


def ring_sha(np, trace) -> str:
    """sha256 of a run's written ring, little-endian int32, row-major."""
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(trace.events, dtype="<i4")
                          .tobytes()).hexdigest()


def _same_trace(np, a, b, what: str, ring_only: bool = False):
    """Two runs' recorders equal: the ring elementwise, `emitted`, `dropped`
    and the time series (and, unless `ring_only`, every other field)."""
    ta, tb = a.trace, b.trace
    if ((ta.emitted, ta.dropped, ta.ring_capacity) != (tb.emitted, tb.dropped,
                                                       tb.ring_capacity)
            or ta.events.shape != tb.events.shape
            or not np.array_equal(ta.events, tb.events)):
        raise SystemExit(f"{what}: rings differ ({ta.emitted} vs {tb.emitted} emitted)")
    if not np.array_equal(a.timeseries.data, b.timeseries.data):
        raise SystemExit(f"{what}: time series differ")
    if not ring_only:
        _assert_equal(np, a, b, skip=("trace", "timeseries"), what=what)


def _trace100(sim, np, label: str, device: str):
    """One drained W=100 [trace] run on `device` (`label` a tuple of
    strategies: their sweep): (result or results, wall s)."""
    from repro_torch.core import linkstate as lstate
    from repro_torch.core import tasks, tracing
    from repro_torch.core import topology as topo

    mesh = topo.MeshTopology.square(100)
    wl = tasks.FibWorkload(n=34, cutoff=18)
    first = label[0] if isinstance(label, tuple) else label
    cfg = dict(hop_ticks=5, capacity=CAP_MAIN, trace=tracing.TraceConfig(*TRACE_100),
               deque_backend=TRACE_100_BACKEND[first])
    kw = {}
    if label == "radiation/tc":
        cfg.update(recovery=sim.Recovery.TC, ckpt_interval=FAULT_CKPT)
        kw = fault_schedules(np, 100, DRAINED_TICKS // 2)["radiation"]
    else:
        cfg["strategy"] = sim.stealing.Strategy(first.split("/")[0])
        if first.endswith("partition"):
            kw = {"linkstate": trace_partition(np, lstate, mesh)}
    cfg = sim.SimConfig(**cfg)
    t0 = time.perf_counter()
    if isinstance(label, tuple):
        code = sim.stealing.strategy_code
        r = sim.simulate_sweep(wl, mesh, cfg, [cfg.params._replace(strategy=code(s))
                                               for s in label], device=device)
    else:
        r = sim.simulate(wl, mesh, cfg, device=device, **kw)
    return r, time.perf_counter() - t0


def _trace_cpu_run(label: str):
    """The port's CPU run of one drained W=100 [trace] configuration (in a
    worker process, beside the card runs of the main process)."""
    import numpy as np
    import torch

    from repro_torch.core import simulator as sim

    torch.set_num_threads(1)
    return _trace100(sim, np, label, "cpu")


def phase_trace(torch, np, sim, topo, tasks, ops, main_run, main_ms, link):
    """The flight recorder on the card. At W=4096: the main path traced in
    four modes (leap/loop, leap/staged, famine batch 0, tick mode), every
    ring and time series equal, every other field equal to `[main]`'s
    untraced run but `events`; `events`, `emitted` and the ring's sha256 the
    reference's; ms/event and device activities an event traced against
    untraced in profiled 300-tick windows; the dynamic constellation
    (`link`: `phase_linkstate`'s tables and runs) traced under NEIGHBOR and
    GLOBAL, each equal to its untraced run but in `events` and to its
    tick-mode run in the ring. At W=100, drained: the three strategies, GLOBAL
    across a partition (the famine replay's NO_LIVE events) and radiation
    under TC, each card == CPU and equal to the reference's pinned (events,
    emitted, ring sha256); a traced 3-seed `simulate_batch`, each seed its
    own `simulate`. Returns the launches by kernel."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(len(TRACE_100_BACKEND),
                               mp_context=multiprocessing.get_context("spawn"))
    cpu = {label: pool.submit(_trace_cpu_run, label) for label in TRACE_100_BACKEND}
    try:
        out = _phase_trace(torch, np, sim, topo, tasks, ops, main_run, main_ms, link, cpu)
    finally:
        pool.shutdown(cancel_futures=True)
    print(f"[trace] phase {time.perf_counter() - t0:.3f} s")
    return out


def _phase_trace(torch, np, sim, topo, tasks, ops, main_run, main_ms, link, cpu):
    import dataclasses

    from repro_torch.core import tracing

    mesh, wl, base = _main_setup(sim, topo, tasks)
    tc = tracing.TraceConfig(*TRACE_MAIN)
    launches = {"steal_compact": 0, "deque_apply": 0}

    def run(label, wl_, mesh_, cfg, **kw):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        r = sim.simulate(wl_, mesh_, cfg, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        counts = {k: ops.LAUNCHES[k] for k in launches}
        kernel = "deque_apply" if cfg.deque_backend == "staged" else "steal_compact"
        if counts[kernel] == 0:
            raise SystemExit(f"[trace] {label}: kernel {kernel} was never launched")
        for k in launches:
            launches[k] += counts[k]
        if r.trace.dropped:
            raise SystemExit(f"[trace] {label}: the ring dropped {r.trace.dropped} events")
        return r, dt, counts

    def pinned(label, r, pin):
        got = (r.events, r.trace.emitted, ring_sha(np, r.trace))
        if got != pin:
            raise SystemExit(f"[trace] {label}: (events, emitted, ring sha256) {got}, "
                             f"the reference's {pin}")

    print(f"[trace] W={W_MAIN}, the [main] configuration traced: ring {tc.ring_capacity} "
          f"rows ({(tc.ring_capacity + 1) * tracing.NUM_LANES * 4} bytes on the card), "
          f"{tc.bins} bins of {tc.bin_ticks} ticks")
    # a short traced run of each backend first, untimed (capture, first use)
    for backend in ("loop", "staged"):
        sim.simulate(wl, mesh, sim.SimConfig(**{**base, "max_ticks": 20},
                                             deque_backend=backend, trace=tc))
    first = None
    for label, extra in TRACE_MODES:
        r, dt, counts = run(label, wl, mesh, sim.SimConfig(**base, **extra, trace=tc))
        _assert_equal(np, main_run, r, skip=_UNTRACED,
                      what=f"[trace] {label} vs [main]'s untraced run")
        first = first or r
        _same_trace(np, first, r, f"[trace] leap/loop vs {label}", ring_only=True)
        if label.startswith("leap"):
            pinned(label, r, TRACE_PINS["main fb=0" if "fb=0" in label else "main"])
        elif r.events != r.ticks:
            raise SystemExit(f"[trace] {label}: {r.events} events")
        kinds = ", ".join(f"{k} {v}" for k, v in r.trace.counts().items() if v)
        print(f"[trace] W={W_MAIN} {label}: ticks={r.ticks} events={r.events} "
              f"wall={dt:.3f} s ms/event={dt / r.events * 1e3:.3f} emitted="
              f"{r.trace.emitted} dropped={r.trace.dropped} ({kinds}) launches={counts}")
    print(f"[trace] W={W_MAIN}: the four modes' rings and time series equal; every "
          f"untraced field equals [main]'s; events, emitted and the ring's sha256 equal "
          f"the reference's ({TRACE_PINS['main'][0]} and {TRACE_PINS['main fb=0'][0]} "
          f"events at famine batch 64 and 0)")
    # where the time goes: 300-tick windows, untraced and traced, timed, then
    # profiled (the graph replays' kernels)
    per = {}
    for tag, trace in (("untraced", None), ("traced", tc)):
        win = sim.SimConfig(**{**base, "max_ticks": 300}, trace=trace)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ev = sim.simulate(wl, mesh, win).events
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
        busy, n_dev, by_name = _profile(torch, lambda: sim.simulate(wl, mesh, win))
        per[tag] = (wall_ms / ev, n_dev / ev, busy / ev)
        print(f"[profile] trace {tag} leap/loop W={W_MAIN}, 300 ticks, {ev} events: "
              f"wall {wall_ms:.3f} ms ({wall_ms / ev:.3f} ms/event), device busy "
              f"{busy:.3f} ms (busy share {busy / wall_ms:.4f}; {busy / ev:.3f} ms an "
              f"event); {n_dev} device activities = {n_dev / ev:.1f} per event")
        for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"[profile]   {ms:9.3f} ms {cnt:7d}x {name[:90]}")
    (wu, au, bu), (wt, at, bt) = per["untraced"], per["traced"]
    print(f"[trace] traced / untraced, 300-tick windows: ms/event {wt:.3f} / {wu:.3f} = "
          f"{wt / wu:.3f}x; activities an event {at:.1f} / {au:.1f} = {at / au:.3f}x "
          f"(+{at - au:.1f}); device busy an event {bt:.3f} / {bu:.3f} ms = "
          f"{bt / bu:.3f}x; [main]'s full untraced run {main_ms:.3f} ms/event")

    # the dynamic constellation, traced: NEIGHBOR and GLOBAL leap/loop, each
    # against its untraced [linkstate] run and its own tick-mode run
    tcl = tracing.TraceConfig(*TRACE_LINK)
    for strategy in ("neighbor", "global"):
        untraced = link["runs"][f"{strategy} leap/loop"]
        got = {}
        for mode in ("leap", "tick"):
            cfg = sim.SimConfig(**link["base"], strategy=sim.stealing.Strategy(strategy),
                                step_mode=mode, trace=tcl)
            r, dt, counts = run(f"linkstate {strategy} {mode}", wl, link["mesh"], cfg,
                                linkstate=link["tbl"], **link["kw"])
            _assert_equal(np, untraced, r, skip=_UNTRACED,
                          what=f"[trace] linkstate {strategy} {mode} vs untraced")
            got[mode] = r
            c = r.trace.counts()
            print(f"[trace] linkstate W={W_MAIN} {strategy} {mode}: events={r.events} "
                  f"(untraced leap {untraced.events}) wall={dt:.3f} s ms/event="
                  f"{dt / r.events * 1e3:.3f} emitted={r.trace.emitted} epoch={c['epoch']} "
                  f"death={c['death']} wake={c['wake']} no_live={c['no_live_victim']} "
                  f"severed={c['severed_denial']} launches={counts}")
        if got["tick"].events != got["tick"].ticks:
            raise SystemExit(f"[trace] linkstate {strategy} tick: {got['tick'].events} events")
        _same_trace(np, got["leap"], got["tick"], f"[trace] linkstate {strategy} leap vs tick",
                    ring_only=True)
    print("[trace] linkstate: traced runs equal their untraced runs but in events, and "
          "their tick-mode runs in the ring and time series")

    # drained W=100: card == CPU, the reference's pins (the three strategies
    # as one sweep on the card, each point against its own CPU run)
    card_runs = (TRACE_100_SWEEP,) + tuple(k for k in TRACE_100_BACKEND
                                           if k not in TRACE_100_SWEEP)
    for label in card_runs:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rgs, dt = _trace100(sim, np, label, "cuda")
        torch.cuda.synchronize()
        counts = {k: ops.LAUNCHES[k] for k in launches}
        labels = label if isinstance(label, tuple) else (label,)
        rgs = rgs if isinstance(label, tuple) else [rgs]
        backend = TRACE_100_BACKEND[labels[0]]
        kernel = "deque_apply" if backend == "staged" else "steal_compact"
        if counts[kernel] == 0:
            raise SystemExit(f"[trace] W=100 {label}: {kernel} never launched")
        for k in launches:
            launches[k] += counts[k]
        iters = max(r.events for r in rgs)
        for one, rg in zip(labels, rgs):
            pinned(f"W=100 {one}", rg, TRACE_PINS[one])
            if rg.result != 5702887:
                raise SystemExit(f"[trace] W=100 {one}: result {rg.result} not exact")
            rc, dt_c = cpu[one].result()
            _same_trace(np, rg, rc, f"[trace] W=100 {one} card vs cpu")
            c = rg.trace.counts()
            print(f"[trace] W=100 {one} ({backend}): ticks={rg.ticks} events={rg.events} "
                  f"emitted={rg.trace.emitted} = the reference's, ring sha256 too; "
                  f"no_live={c['no_live_victim']} severed={c['severed_denial']} "
                  f"granted={c['granted']} death={c['death']}; cpu {dt_c:.3f} s in a "
                  f"worker process, card == cpu")
        print(f"[trace] W=100 {' + '.join(labels)} on the card: {dt:.3f} s, {iters} loop "
              f"iterations ({dt / iters * 1e3:.3f} ms each); launches={counts}")

    # a traced batch: a ring per seed, each its own traced run
    wl26, mesh100 = tasks.FibWorkload(n=26, cutoff=14), topo.MeshTopology.square(100)
    cfg = sim.SimConfig(hop_ticks=5, capacity=CAP_MAIN, trace=tracing.TraceConfig(*TRACE_100))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    batch = sim.simulate_batch(wl26, mesh100, cfg, seeds=(0, 1, 2))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches["steal_compact"] += ops.LAUNCHES["steal_compact"]
    for seed, rb in zip((0, 1, 2), batch):
        one, _, _ = run(f"batch seed {seed}", wl26, mesh100, dataclasses.replace(cfg, seed=seed))
        _same_trace(np, one, rb, f"[trace] batch seed {seed} vs its own run")
    print(f"[trace] simulate_batch of seeds 0, 1, 2 at W=100 (FIB n=26 cutoff=14): "
          f"{dt:.3f} s, emitted {[r.trace.emitted for r in batch]}; each seed equal to "
          f"its own traced simulate, ring included")
    return launches


# the [arrivals] phase: open-loop traffic (`repro_torch.core.arrivals`) on
# the main path's mesh, in the load–latency benchmark's shape
# (benchmarks/load_latency.py: a FIB n=8 cutoff=4 max_leaf_cost=4 seed
# root, requests at ground stations) at constellation scale: 64 Zipf (s=1)
# stations, requests of 512 work units, 8 a candidate, capacity 256,
# 2,000 ticks, NEIGHBOR and GLOBAL at tau 5, offered loads in work units a
# worker-tick (gap_q8 1280, 512, 320)
ARR_SHAPE = dict(task_cost=512, num_stations=64, zipf_s=1.0, station_seed=0)
ARR_ROOT = dict(n=8, cutoff=4, max_leaf_cost=4)
ARR_BATCH, ARR_CAP, ARR_TICKS, ARR_TAU = 8, 256, 2000, 5
ARR_LOADS = (0.2, 0.5, 0.8)
ARR_STRATEGIES = ("neighbor", "global")
# the grid's recorder: ring rows, bins, bin ticks
ARR_TRACE = (1 << 21, 64, 32)
# the open constellation: [linkstate]'s dynamic constellation (2 orbits of 1,024
# ticks) with the diurnal rate schedule over 2,048 ticks, NEIGHBOR at 0.5
ARR_ORBITS = 2


def arr_gap_q8(arrivals, load: float) -> int:
    """`arrival_gap_q8` of an offered load (work units a worker-tick) at
    W_MAIN workers (`arrivals`: either package's module)."""
    return arrivals.gap_q8_for_load(load * W_MAIN / ARR_SHAPE["task_cost"], ARR_BATCH)


def arr_config(sim, strategy: str, load: float, arrivals, **extra):
    """The [arrivals] phase's `SimConfig` of one (strategy, load) point
    (`sim`, `arrivals`: either package's modules)."""
    base = dict(strategy=sim.stealing.Strategy(strategy), hop_ticks=ARR_TAU,
                capacity=ARR_CAP, max_ticks=ARR_TICKS, arrival_batch=ARR_BATCH,
                arrival_gap_q8=arr_gap_q8(arrivals, load))
    return sim.SimConfig(**{**base, **extra})


def result_digest(np, r, skip=()) -> str:
    """sha256 of every field of a `SimResult` (either package's) but `skip`:
    scalars by value, arrays as little-endian int64, the ring as int32, the
    `sojourn` dict sorted by key."""
    import hashlib

    h = hashlib.sha256()
    for f in r._fields:
        if f in skip:
            continue
        v = getattr(r, f)
        h.update(f.encode())
        if f == "trace" and v is not None:
            h.update(np.ascontiguousarray(v.events, dtype="<i4").tobytes())
            h.update(repr((v.emitted, v.dropped, v.ring_capacity)).encode())
        elif f == "timeseries" and v is not None:
            h.update(np.ascontiguousarray(v.data, dtype="<i8").tobytes())
            h.update(repr(v.bin_ticks).encode())
        elif isinstance(v, np.ndarray):
            h.update(np.ascontiguousarray(v, dtype="<i8").tobytes())
        elif isinstance(v, dict):
            h.update(repr(sorted(v.items())).encode())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


# the reference's (`repro.core.simulator`, JAX on a CPU) runs of the phase,
# printed by tests/arrival_pins.py: (events, `result_digest` of every
# SimResult field) — the traced grid points, NEIGHBOR 0.5 untraced at famine
# batch 64 and 0, and the open constellation untraced
ARR_PINS = {
    "neighbor 0.2": (1185, "abd5f641140372faf70cd12ca9e3b925542d47ee0bae4a99a933697c66b9784f"),
    "neighbor 0.5": (1416, "015c2e68d97e7bb74754fdac084c4650114577f6103542910b245fde8dc12be4"),
    "neighbor 0.8": (1582, "a734cea7d1d7aa4426465035529f2cc238494fc848d99f074c324f90c96672fc"),
    "global 0.2": (1364, "467d9379b8e657b23c5f37263cdf841b70c7477dede7e61224dd4860edbe688b"),
    "global 0.5": (1579, "f32fea61552d703b2c721bd81af490049d8afda2ad648e812e383e753b9fadd8"),
    "global 0.8": (1742, "680bb428fb3a5c5ce289c9bb564ba765318cc415bf73fc8fa619e8d1dd9203bf"),
    "untraced neighbor 0.5": (
        1412, "f5ebacc8de13a4e946e57a7005d9043b4da51d1c4652b6af79a3b703b2dd3a0d"),
    "untraced neighbor 0.5 fb=0": (
        1864, "6abbdb9b7b6afadd3ba80d768b336b4b752f8414c47dfc6752dc75eecaa3715a"),
    "constellation": (1699, "17f653703d7356969b3caed04c56531b218af7f91e73593d6f962d2761788119"),
}
# tests/test_arrivals.py's four ARRIVAL_SCENARIOS and its TC rollback run
# (FIB n=12 cutoff=6 max_leaf_cost=8 on 16 workers, ring 2^13; TC: FIB n=14
# cutoff=7 on 9 workers, deaths at 70 and 150, snapshots every 30): label,
# ArrivalConfig fields, SimConfig fields; each card == CPU
ARR_SCENARIOS = {
    "poisson": (dict(task_cost=7), dict(arrival_gap_q8=5 * 256, seed=3)),
    "bursty": (dict(task_cost=5, num_stations=6, on_ticks=40, off_ticks=160),
               dict(arrival_gap_q8=2 * 256, seed=3, deque_backend="staged")),
    "zipf_hot": (dict(task_cost=9, num_stations=2, zipf_s=2.0),
                 dict(arrival_gap_q8=256, arrival_batch=8, seed=3)),
    "rate_flip_midfamine": (dict(task_cost=5, num_stations=3, zipf_s=1.5,
                                 rate_starts=(0, 400, 800), rate_scale=(1.0, 0.05, 1.0)),
                            dict(arrival_gap_q8=30 * 256, seed=5, deque_backend="staged")),
    "tc_rollback": (dict(task_cost=6, num_stations=3),
                    dict(arrival_gap_q8=4 * 256, seed=2, ckpt_interval=30,
                         deque_backend="staged")),
}
# the four modes of the NEIGHBOR 0.5 point, untraced
ARR_MODES = (("leap/loop", {}),
             ("leap/staged", {"deque_backend": "staged"}),
             ("leap/loop fb=0", {"famine_batch": 0}),
             ("tick/staged", {"step_mode": "tick", "deque_backend": "staged"}))


def _arr_scenario(sim, label: str, device: str):
    """One of ARR_SCENARIOS on `device`: (result, wall s)."""
    from repro_torch.core import arrivals, tasks, tracing
    from repro_torch.core import topology as topo

    shape, fields = ARR_SCENARIOS[label]
    fields = dict(fields)
    kw = {}
    if label == "tc_rollback":
        import numpy as np

        mesh, wl = topo.MeshTopology.square(9), tasks.FibWorkload(n=14, cutoff=7,
                                                                  max_leaf_cost=8)
        fields.update(recovery=sim.Recovery.TC, max_ticks=1000)
        ft = -np.ones(9, np.int32)
        ft[2], ft[5] = 70, 150
        kw["fail_time"] = ft
    else:
        mesh, wl = topo.MeshTopology.square(16), tasks.FibWorkload(n=12, cutoff=6,
                                                                   max_leaf_cost=8)
        fields.setdefault("max_ticks", 1200)
    cfg = sim.SimConfig(capacity=1024, trace=tracing.TraceConfig(ring_capacity=1 << 13),
                        **fields)
    t0 = time.perf_counter()
    r = sim.simulate(wl, mesh, cfg, arrivals=arrivals.ArrivalConfig(**shape),
                     device=device, **kw)
    return r, time.perf_counter() - t0


def _arrivals_cpu_run(label: str):
    """The port's CPU run of one ARR_SCENARIOS entry (in a worker process,
    beside the card runs of the main process)."""
    import torch

    from repro_torch.core import simulator as sim

    torch.set_num_threads(1)
    return _arr_scenario(sim, label, "cpu")


def phase_arrivals(torch, np, sim, topo, tasks, ops, ref, deque, main_ms, link):
    """Open-loop arrivals on the card. (a) The (strategy x load) grid at
    W=4096 traced as one `simulate_sweep`: every point's fields, ring and
    sojourn percentiles the reference's (ARR_PINS), no ring drop, NEIGHBOR
    0.8 equal to its own `simulate`; walls and requests done a wall second.
    (b) NEIGHBOR 0.5 untraced in four modes, equal but in `events`, `events`
    the reference's; a profiled 300-tick window against `[main]`'s. (c) The
    open constellation (`link`: `phase_linkstate`'s tables) with the diurnal
    rate schedule: the reference's, and leap == tick. (d) tests/
    test_arrivals.py's scenarios and TC rollback, card == CPU. (e) `log_f32`
    and `gap_ticks`, card == CPU. (f) `deque_apply` at the arrival lane
    width. Returns (launches by kernel, deque_apply at L = 17)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(len(ARR_SCENARIOS),
                               mp_context=multiprocessing.get_context("spawn"))
    cpu = {label: pool.submit(_arrivals_cpu_run, label) for label in ARR_SCENARIOS}
    try:
        out = _phase_arrivals(torch, np, sim, topo, tasks, ops, ref, deque, main_ms,
                              link, cpu)
    finally:
        pool.shutdown(cancel_futures=True)
    print(f"[arrivals] phase {time.perf_counter() - t0:.3f} s")
    return out


def _phase_arrivals(torch, np, sim, topo, tasks, ops, ref, deque, main_ms, link, cpu):
    from repro_torch.core import arrivals, tracing
    from repro_torch.core.f32math import log_f32

    mesh = topo.MeshTopology.square(W_MAIN)
    wl = tasks.FibWorkload(**ARR_ROOT)
    ar = arrivals.device_tables(arrivals.ArrivalConfig(**ARR_SHAPE), mesh, "cuda")
    launches = {"steal_compact": 0, "deque_apply": 0}

    def timed(label, fn, kernels=("steal_compact",)):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        counts = {k: ops.LAUNCHES[k] for k in launches}
        for k in kernels:
            if counts[k] == 0:
                raise SystemExit(f"[arrivals] {label}: kernel {k} was never launched")
        for k in launches:
            launches[k] += counts[k]
        return r, dt, counts

    def pinned(label, r, pin_label=None):
        want = ARR_PINS[pin_label or label]
        got = (r.events, result_digest(np, r))
        if got != want:
            raise SystemExit(f"[arrivals] {label}: (events, digest) {got}, the "
                             f"reference's {want}")

    print(f"[arrivals] W={W_MAIN}: FIB {ARR_ROOT} seed root, {ARR_SHAPE}, batch "
          f"{ARR_BATCH}, capacity {ARR_CAP}, {ARR_TICKS} ticks, tau {ARR_TAU}; loads "
          f"{ARR_LOADS} work units a worker-tick = gap_q8 "
          f"{[arr_gap_q8(arrivals, ld) for ld in ARR_LOADS]}")
    # (a) the load grid, traced, one sweep; a short grid first, untimed
    trc = tracing.TraceConfig(*ARR_TRACE)
    labels = [f"{s} {ld}" for s in ARR_STRATEGIES for ld in ARR_LOADS]
    pts = [arr_config(sim, s, ld, arrivals, trace=trc)
           for s in ARR_STRATEGIES for ld in ARR_LOADS]
    short = [arr_config(sim, s, ld, arrivals, trace=trc, max_ticks=20)
             for s in ARR_STRATEGIES for ld in ARR_LOADS]
    sim.simulate_sweep(wl, mesh, short[0].static, short, arrivals=ar)
    res, grid_s, counts = timed("grid", lambda: sim.simulate_sweep(
        wl, mesh, pts[0].static, pts, arrivals=ar))
    iters = max(r.events for r in res)
    for label, r in zip(labels, res):
        if r.trace.dropped:
            raise SystemExit(f"[arrivals] {label}: the ring dropped {r.trace.dropped}")
        pinned(label, r)
        soj = r.sojourn
        print(f"[arrivals] {label}: ticks={r.ticks} events={r.events} injected="
              f"{r.arrivals_injected} dropped={r.arrivals_dropped} done="
              f"{r.requests_done} p50={soj['p50']} p99={soj['p99']} p999={soj['p999']} "
              f"emitted={r.trace.emitted} (ring dropped 0); every field, the ring and "
              f"sojourn the reference's")
    done = sum(r.requests_done for r in res)
    print(f"[arrivals] grid of {len(pts)} points ({len(pts) * W_MAIN} workers) in one "
          f"sweep: {grid_s:.3f} s, {iters} loop iterations ({grid_s / iters * 1e3:.3f} ms "
          f"each), {done} requests done = {done / grid_s:.1f} a wall second; "
          f"launches={counts}")
    one, one_s, _ = timed("neighbor 0.8", lambda: sim.simulate(wl, mesh, pts[2],
                                                                  arrivals=ar))
    _same_trace(np, res[2], one, "[arrivals] neighbor 0.8 grid point vs its own run")
    print(f"[arrivals] neighbor 0.8 alone: {one_s:.3f} s, {one.events} events, equal "
          f"to its grid point in every field")

    # (b) NEIGHBOR 0.5 untraced in four modes, then a profiled window
    runs = {}
    for label, extra in ARR_MODES:
        kernel = "deque_apply" if extra.get("deque_backend") == "staged" else "steal_compact"
        cfg = arr_config(sim, "neighbor", 0.5, arrivals, **extra)
        r, dt, counts = timed(label, lambda: sim.simulate(wl, mesh, cfg, arrivals=ar),
                              (kernel,))
        runs[label] = r
        if label.startswith("tick"):
            if r.events != r.ticks:
                raise SystemExit(f"[arrivals] {label}: {r.events} events")
        else:
            pinned(f"neighbor 0.5 {label}", r, "untraced neighbor 0.5"
                   + (" fb=0" if "fb=0" in label else ""))
        _assert_equal(np, runs["leap/loop"], r, skip=("events",),
                      what=f"[arrivals] neighbor 0.5 leap/loop vs {label}")
        print(f"[arrivals] neighbor 0.5 {label}: ticks={r.ticks} events={r.events} "
              f"wall={dt:.3f} s ms/event={dt / r.events * 1e3:.3f} injected="
              f"{r.arrivals_injected} dropped={r.arrivals_dropped} done="
              f"{r.requests_done} launches={counts}")
    win = arr_config(sim, "neighbor", 0.5, arrivals, max_ticks=300)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev = sim.simulate(wl, mesh, win, arrivals=ar).events
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
    busy, n_dev, by_name = _profile(torch, lambda: sim.simulate(wl, mesh, win, arrivals=ar))
    m_ms, m_act, m_share = MAIN_WINDOW["leap/loop"]
    print(f"[profile] arrivals neighbor 0.5 leap/loop W={W_MAIN}, 300 ticks, {ev} events: "
          f"wall {wall_ms:.3f} ms ({wall_ms / ev:.3f} ms/event, {wall_ms / ev / m_ms:.3f}x "
          f"[main]'s {m_ms:.3f}), device busy {busy:.3f} ms (busy share "
          f"{busy / wall_ms:.4f}, [main]'s {m_share:.4f}); {n_dev} device activities = "
          f"{n_dev / ev:.1f} per event ([main]'s {m_act:.1f}, {n_dev / ev - m_act:+.1f}); "
          f"[main]'s full run {main_ms:.3f} ms/event")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"[profile]   {ms:9.3f} ms {cnt:7d}x {name[:90]}")

    # (c) the open constellation: sparse tables, sleepers as dead stations
    con = link["con"]
    starts, scale = con.traffic_schedule(ARR_ORBITS * con.cfg.orbit_ticks)
    ar_c = arrivals.device_tables(arrivals.ArrivalConfig(
        **ARR_SHAPE, rate_starts=starts, rate_scale=scale), link["mesh"], "cuda")
    got = {}
    for mode in ("leap", "tick"):
        cfg = arr_config(sim, "neighbor", 0.5, arrivals, preshed=True,
                         warn_ticks=con.cfg.warn_ticks, step_mode=mode)
        r, dt, counts = timed(f"constellation {mode}", lambda: sim.simulate(
            wl, link["mesh"], cfg, linkstate=link["tbl"], arrivals=ar_c, **link["kw"]))
        got[mode] = r
        print(f"[arrivals] constellation neighbor 0.5 {mode}: ticks={r.ticks} "
              f"events={r.events} wall={dt:.3f} s ms/event={dt / r.events * 1e3:.3f} "
              f"injected={r.arrivals_injected} dropped={r.arrivals_dropped} "
              f"(dead stations and overflow) done={r.requests_done} launches={counts}")
    pinned("constellation", got["leap"])
    _assert_equal(np, got["leap"], got["tick"], skip=("events",),
                  what="[arrivals] constellation leap vs tick")
    if got["tick"].events != got["tick"].ticks:
        raise SystemExit(f"[arrivals] constellation tick: {got['tick'].events} events")
    print(f"[arrivals] constellation ({len(starts)} rate epochs): the reference's "
          f"fields; tick mode equal but in events")

    # (d) the reference's scenarios and TC rollback: card == CPU
    for label, (shape, fields) in ARR_SCENARIOS.items():
        kernel = ("deque_apply" if fields.get("deque_backend") == "staged"
                  else "steal_compact")
        (rg, dt), _, counts = timed(label, lambda: _arr_scenario(sim, label, "cuda"),
                                    (kernel,))
        rc, dt_c = cpu[label].result()
        _same_trace(np, rg, rc, f"[arrivals] {label} card vs cpu")
        print(f"[arrivals] W={16 if label != 'tc_rollback' else 9} {label}: ticks="
              f"{rg.ticks} events={rg.events} injected={rg.arrivals_injected} "
              f"dropped={rg.arrivals_dropped} done={rg.requests_done}; card {dt:.3f} s, "
              f"cpu {dt_c:.3f} s in a worker process, card == cpu; launches={counts}")

    # (e) the reference's float32 log and the gaps, card == CPU
    gen = torch.Generator().manual_seed(24)
    h = torch.randint(0, 2**32, (1 << 24,), generator=gen, dtype=torch.int64)
    u = (h.to(torch.float32) + 1.0) * 2.0**-32
    if not torch.equal(log_f32(u.cuda()).cpu().view(torch.int32),
                       log_f32(u).view(torch.int32)):
        raise SystemExit("[arrivals] log_f32: card != CPU")
    k = torch.arange(1 << 22, dtype=torch.int32)
    aseed = arrivals.stream_seed(torch.tensor(0))
    for g in (8, 256, 1280, 7680, 12345):
        gap = torch.tensor(g, dtype=torch.int32)
        if not torch.equal(arrivals.gap_ticks(aseed.cuda(), k.cuda(), gap.cuda()).cpu(),
                           arrivals.gap_ticks(aseed, k, gap)):
            raise SystemExit(f"[arrivals] gap_ticks at gap_q8 {g}: card != CPU")
    print(f"[arrivals] log_f32 on {u.numel()} u and gap_ticks on {k.numel()} candidates "
          f"x 5 gaps: card == CPU bit for bit")

    # (f) deque_apply at the arrival path's push-log width
    L = tasks.EXPAND_K + 1 + arrivals.ARRIVAL_K
    rs = np.random.default_rng(20261018)
    buf = torch.as_tensor(rs.integers(-2**31, 2**31 - 1, (W_MAIN, ARR_CAP, 4),
                                      dtype=np.int64).astype(np.int32), device="cuda")
    bot = torch.as_tensor(rs.integers(0, ARR_CAP, W_MAIN).astype(np.int32), device="cuda")
    size = torch.as_tensor(rs.integers(0, ARR_CAP + 1, W_MAIN).astype(np.int32),
                           device="cuda")
    da = _deque_apply_at(torch, np, ops, ref, deque, rs, buf, bot, size, L)
    da["lanes"] = L
    print(f"[arrivals] deque_apply at {W_MAIN} rows, C={ARR_CAP}, L={L} lanes: exact, "
          f"gated and n = 0 rows bit for bit; device per launch: kernel {da['ms']:.6f} "
          f"ms, plain {da['plain_ms']:.6f} ms, library {da['library_ms']:.6f} ms "
          f"(in-place index_put_), bound {da['bound_ms']:.6f} ms ({da['bound_by']}, "
          f"{da['bytes']} bytes); eager wrapper call {da['call_ms']:.6f} ms")
    return launches, da


# the round executor (`repro_torch.core.scheduler`) at the paper's widest
# configuration: 16 nodes x 40 cores = 640 workers on `MeshTopology.square`'s
# 25x26 grid (src/repro/configs/paper_mesh.py), Fig. 3's settings (capacity
# 4096, 2,000,000 rounds at most), GLOBAL and NEIGHBOR x seeds 0-2 as one
# `run_sweep` a workload: Fig. 3's two trees (FIB_QUICK, UTS_QUICK) and the
# steady-phase FIB of paper_mesh (`fib`, the measurement)
SCHED_W, SCHED_CAP, SCHED_MAX_ROUNDS = 640, 4096, 2_000_000
SCHED_WORKLOADS = {"FIB": ("fib", dict(n=44, cutoff=24, max_leaf_cost=32), 8),
                   "UTS": ("uts", dict(b0=4.0, d_max=16, root_seed=19), 2),
                   "FIB_STEADY": ("fib", dict(n=44, cutoff=24, max_leaf_cost=192), 8)}
# each workload's grid: GLOBAL then NEIGHBOR, each at these seeds; the
# steady FIB at seed 0 alone (its NEIGHBOR point runs 33,566 rounds, the
# grid's wall, and at ~4.5 ms a round three seeds cost only ~5% more: the
# round is launch-bound; the cut keeps the phase short all the same)
SCHED_SEEDS = {"FIB": (0, 1, 2), "UTS": (0, 1, 2), "FIB_STEADY": (0,)}


def sched_grid(name: str) -> tuple:
    return tuple((strategy, seed) for strategy in ("global", "neighbor")
                 for seed in SCHED_SEEDS[name])


# the reference's (`repro.core.scheduler.run_sweep`, JAX on a CPU) points of
# each `sched_grid`, in order (printed by tests/sched_pins.py): result,
# rounds, nodes, attempts, successes, overflow, then the first 16 hex digits
# of the sha256 of per_worker_busy, per_worker_attempts and
# per_worker_successes (int32 bytes)
SCHED_PINS = {
    "FIB": (
        (701408733, 795, 35421, 161724, 10091, 0,
         "5abadc45a5c9df66", "84f4ba18736dc022", "685871a09e0a1328"),
        (701408733, 794, 35421, 153828, 10896, 0,
         "49731ca332f2da63", "f6ae17c8913f3b2d", "47eb3aa32deaea62"),
        (701408733, 794, 35421, 153167, 10916, 0,
         "36c0927cfaddf623", "a155af1ab29a4339", "08c7c14de6aa3d2c"),
        (701408733, 5632, 35421, 24929255, 33027, 0,
         "e34c46f4706ffed6", "5e2cff8f10af0877", "a272e480f943eeaf"),
        (701408733, 5475, 35421, 24126076, 32262, 0,
         "32f3c43249252405", "037538f7c99474a8", "1a6c4956f661616c"),
        (701408733, 5211, 35421, 22774142, 32540, 0,
         "3b2033ba0d692c40", "107ccabf0933a68d", "6fc3a261270978c4"),
    ),
    "UTS": (
        (250777, 232, 250777, 83660, 29517, 0,
         "c21706fe2c26a3b6", "56d7edad868bd0e2", "33e4a301b7a6c7e7"),
        (250777, 232, 250777, 82234, 30086, 0,
         "d1ca47b2c23f0f15", "90533d6f8d6a77db", "a1b5475884d36885"),
        (250777, 231, 250777, 80663, 29633, 0,
         "975e2d29db5fa37b", "4d2342d79fbc81e2", "c75743426f4c526f"),
        (250777, 2142, 250777, 9795573, 144009, 0,
         "5ef055477508850e", "abcc40a3f764c3f0", "4489a2e706ceacd8"),
        (250777, 2648, 250777, 12370891, 160202, 0,
         "cdc1b4bf0d278d1a", "8b1a94f5dad8573e", "8699c5f6466b9ccc"),
        (250777, 2528, 250777, 11748199, 164138, 0,
         "3b3c6b1335356dd9", "277ae8bba7bc2202", "24697846a3839324"),
    ),
    "FIB_STEADY": (
        (701408733, 4666, 35421, 611468, 10175, 0,
         "323f4a023541ab42", "804ddc0fafe21f04", "116f103a48cf3fd4"),
        (701408733, 33566, 35421, 148582345, 33415, 0,
         "034c979a87c9736d", "78356d96fd2c4548", "faaa2eef07f55aba"),
    ),
}
# card == CPU at W=100 on tests/test_scheduler.py's FIB, capacity 256: every
# strategy as one sweep, NEIGHBOR under one epoch's link snapshot of the
# dynamic constellation (the most links down), GLOBAL cut at 57 rounds
SCHED_SMALL = dict(n=24, cutoff=10, max_leaf_cost=8)
SCHED_SMALL_RUNS = ("strategies", "link_up", "max_rounds")
SCHED_WINDOW = 297  # a profiled window: the warm-up round and 37 x 8 replays


def sched_row(np, r) -> tuple:
    import hashlib

    def sha(a):
        return hashlib.sha256(np.asarray(a, np.int32).tobytes()).hexdigest()[:16]
    return (r.result, r.rounds, r.nodes, r.attempts, r.successes, r.overflow,
            sha(r.per_worker_busy), sha(r.per_worker_attempts),
            sha(r.per_worker_successes))


def sched_launches(subrounds: int, rounds: int) -> int:
    """`steal_compact`'s launches in one grid on the card: one an export,
    `subrounds` exports a round, over the loop's iterations: the warm-up
    round, then replays in blocks of DONE_EVERY until the slowest point
    stops after `rounds`."""
    from repro_torch.core.simulator import DONE_EVERY

    return subrounds * (1 + DONE_EVERY * -(-(rounds - 1) // DONE_EVERY))


def sched_gap(np, name: str, rounds) -> tuple:
    """Mean rounds of GLOBAL and NEIGHBOR over `sched_grid(name)`'s points,
    and Fig. 4's relative gap (T_n - T_g) / T_g."""
    t = {s: np.mean([n for (st, _), n in zip(sched_grid(name), rounds) if st == s])
         for s in ("global", "neighbor")}
    return t["global"], t["neighbor"], (t["neighbor"] - t["global"]) / t["global"]


def sched_pinned(np, name: str, rs, exact_result) -> float:
    """Hold a W=640 sweep's points to SCHED_PINS[name] (and, where given,
    every result to `exact_result`, with no overflow); returns the
    reference's Fig. 4 gap."""
    for (s, seed), r, want in zip(sched_grid(name), rs, SCHED_PINS[name]):
        if sched_row(np, r) != tuple(want):
            raise SystemExit(f"[scheduler] {name} {s} seed {seed}: "
                             f"{sched_row(np, r)}, the reference's {tuple(want)}")
        if r.overflow or exact_result not in (None, r.result):
            raise SystemExit(f"[scheduler] {name} {s} seed {seed}: not exact")
    return sched_gap(np, name, [row[1] for row in SCHED_PINS[name]])[2]


def _sched_small(label: str, device: str):
    """One of SCHED_SMALL_RUNS on `device`: a list of `RunResult`s and the
    wall seconds."""
    import numpy as np

    from repro_torch.benchmarks.common import dynamic_constellation
    from repro_torch.core import scheduler, tasks
    from repro_torch.core import topology as topo

    wl = tasks.FibWorkload(**SCHED_SMALL)
    mesh = topo.MeshTopology.square(100)
    cfg = scheduler.SchedulerConfig(capacity=256, max_rounds=100_000)
    t0 = time.perf_counter()
    if label == "strategies":
        pts = [cfg.params._replace(strategy=c) for c in range(4)]
        rs = scheduler.run_sweep(wl, mesh, cfg, pts, device=device)
    elif label == "link_up":
        con, sched, _ = dynamic_constellation(100, 5, 10)
        ls = sched.linkstate
        e = int(np.argmax((~ls.link_up).sum(axis=(1, 2))))
        rs = [scheduler.run_vectorized(wl, con.mesh, cfg, ls.up_at(int(ls.epoch_starts[e])),
                                       device=device)]
    else:
        cut = scheduler.SchedulerConfig(strategy=scheduler.stealing.Strategy.GLOBAL,
                                        capacity=256, max_rounds=57)
        rs = [scheduler.run_vectorized(wl, mesh, cut, device=device)]
    return rs, time.perf_counter() - t0


def _sched_cpu_run(label: str):
    import torch

    torch.set_num_threads(1)
    return _sched_small(label, "cpu")


def phase_scheduler(torch, np, ops, ref):
    """The round executor on the card. (a) Fig. 3's largest point: FIB_QUICK
    and UTS_QUICK at W=640 as one 6-point sweep each, every point the
    reference's (SCHED_PINS), FIB exact; the mean rounds per strategy and
    Fig. 4's gap. (b) The steady-phase FIB at W=640, pinned the same way:
    wall, rounds, ms a round, set-up (capture and warm-up) apart, peak
    memory, and a profiled window of replays. (c) Card == CPU at W=100:
    every strategy, a link snapshot, a max_rounds cut. (d) `steal_compact`
    against its plain version at the grids' rows of SCHED_CAP slots.
    Each W=640 grid's launches are counted from 0 just before it and held
    to 8 a loop iteration. Returns ({path: steal_compact's launches}, the
    kernel's `scheduler_*` numbers and max abs error)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(len(SCHED_SMALL_RUNS),
                               mp_context=multiprocessing.get_context("spawn"))
    cpu = {label: pool.submit(_sched_cpu_run, label) for label in SCHED_SMALL_RUNS}
    try:
        out = _phase_scheduler(torch, np, ops, ref, cpu)
    finally:
        pool.shutdown(cancel_futures=True)
    print(f"[scheduler] phase {time.perf_counter() - t0:.3f} s")
    return out


def _phase_scheduler(torch, np, ops, ref, cpu):
    from repro_torch.core import scheduler, tasks
    from repro_torch.core import topology as topo

    mesh = topo.MeshTopology.square(SCHED_W)
    code = scheduler.stealing.strategy_code

    def grid(name, **static):
        kind, fields, expansions = SCHED_WORKLOADS[name]
        wl = (tasks.FibWorkload if kind == "fib" else tasks.UtsWorkload)(**fields)
        cfg = scheduler.SchedulerConfig(capacity=SCHED_CAP, max_rounds=SCHED_MAX_ROUNDS,
                                        expansions_per_round=expansions)
        cfg = dataclasses.replace(cfg, **static)
        pts = [cfg.params._replace(strategy=code(s), seed=seed)
               for s, seed in sched_grid(name)]
        return lambda: scheduler.run_sweep(wl, mesh, cfg, pts), wl

    def exact(wl):  # FIB's result is known; UTS's is the reference's
        return wl.expected_result() if isinstance(wl, tasks.FibWorkload) else None

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t1

    subrounds = scheduler.SchedulerConfig().steal_subrounds
    launches = {}

    def counted(path, fn):
        """`fn`'s grid, timed, with steal_compact's launches counted from 0
        just before it and read just after, held to `sched_launches`."""
        ops.reset_launch_counts()
        rs, dt = timed(fn)
        n = ops.LAUNCHES["steal_compact"]
        rounds = max(r.rounds for r in rs)
        if n != sched_launches(subrounds, rounds):
            raise SystemExit(f"[scheduler] {path}: {n} steal_compact launches, "
                             f"{sched_launches(subrounds, rounds)} expected for "
                             f"{rounds} rounds")
        launches[path] = n
        return rs, dt

    print(f"[scheduler] W={SCHED_W} ({mesh.rows}x{mesh.cols}, last row "
          f"{SCHED_W - (mesh.rows - 1) * mesh.cols} of {mesh.cols}), capacity {SCHED_CAP}, "
          f"GLOBAL, NEIGHBOR x seeds {SCHED_SEEDS} a workload")
    # a short grid first, untimed: the phase's first capture
    grid("FIB", max_rounds=8)[0]()
    # (a) Fig. 3's largest point
    for name in ("FIB", "UTS"):
        fn, wl = grid(name)
        rs, dt = counted(f"scheduler_{name.lower()}_quick", fn)
        want = sched_pinned(np, name, rs, exact(wl))
        tg, tn, rel = sched_gap(np, name, [r.rounds for r in rs])
        if rel != want:
            raise SystemExit(f"[scheduler] {name}: Fig. 4 gap {rel}, the reference's {want}")
        rounds = max(r.rounds for r in rs)
        print(f"[scheduler] {name} {SCHED_WORKLOADS[name][1]}, expansions "
              f"{SCHED_WORKLOADS[name][2]}: result={rs[0].result} nodes={rs[0].nodes}; "
              f"every point the reference's (rounds {[r.rounds for r in rs]}, per-worker "
              f"digests); mean rounds global {tg:.1f} neighbor {tn:.1f}, Fig. 4 gap "
              f"(T_n - T_g)/T_g = {rel * 100:+.4f}% (the reference's); P_success "
              f"{[round(r.p_success, 4) for r in rs]}; wall {dt:.3f} s, {rounds} rounds "
              f"= {dt / rounds * 1e3:.3f} ms a round")

    # (b) the steady phase: set-up apart, the grid, a profiled window
    setup_fn, _ = grid("FIB_STEADY", max_rounds=1)
    _, setup_s = timed(setup_fn)
    fn, wl = grid("FIB_STEADY")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    rs, dt = counted("scheduler", fn)
    peak = torch.cuda.max_memory_allocated()
    sched_pinned(np, "FIB_STEADY", rs, exact(wl))
    tg, tn, rel = sched_gap(np, "FIB_STEADY", [r.rounds for r in rs])
    rounds = max(r.rounds for r in rs)
    work = wl.expected_work_units()
    print(f"[scheduler] FIB_STEADY {SCHED_WORKLOADS['FIB_STEADY'][1]} ({work} work "
          f"units): every point the reference's (rounds {[r.rounds for r in rs]}); "
          f"mean rounds global {tg:.1f} neighbor {tn:.1f}, gap {rel * 100:+.4f}%")
    print(f"[scheduler] FIB_STEADY grid: wall {dt:.3f} s for {rounds} rounds = "
          f"{dt / rounds * 1e3:.3f} ms a round, {rounds / dt:.1f} rounds a wall second "
          f"({len(rs) * work / dt:.0f} work units a wall second over the grid); "
          f"set-up (state, warm-up round, capture, one round's host copy) "
          f"{setup_s:.3f} s, the loop {dt - setup_s:.3f} s = "
          f"{(dt - setup_s) / (rounds - 1) * 1e3:.3f} ms a round; peak device memory "
          f"{peak / 2**30:.3f} GiB ({before / 2**30:.3f} GiB before)")
    win, _ = grid("FIB_STEADY", max_rounds=SCHED_WINDOW)
    _, wall_s = timed(win)
    busy, n_dev, by_name = _profile(torch, win)
    hits = [v for k, v in by_name.items() if "steal_compact_kernel" in k]
    k_ms, k_n = sum(ms for ms, _ in hits), sum(c for _, c in hits)
    if k_n == 0:
        raise SystemExit("[profile] scheduler: no steal_compact kernel seen")
    ring = len(sched_grid("FIB_STEADY")) * SCHED_W * SCHED_CAP * 16
    print(f"[profile] scheduler FIB_STEADY W={SCHED_W} x {len(sched_grid('FIB_STEADY'))} "
          f"points, "
          f"{SCHED_WINDOW} rounds: wall {wall_s * 1e3:.3f} ms ({wall_s * 1e3 / SCHED_WINDOW:.3f} "
          f"ms a round), device busy {busy:.3f} ms (busy share {busy / wall_s / 1e3:.4f}); "
          f"{n_dev} device activities = {n_dev / SCHED_WINDOW:.1f} a round; the grid's "
          f"rings {ring / 2**20:.1f} MiB; steal_compact {k_n}x, {k_ms / k_n * 1e3:.3f} us each")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[profile]   {ms:9.3f} ms {cnt:7d}x {name[:90]}")

    # (c) card == CPU at W=100
    for label in SCHED_SMALL_RUNS:
        rg, dt = _sched_small(label, "cuda")
        rc, dt_c = cpu[label].result()
        for i, (a, b) in enumerate(zip(rg, rc)):
            _assert_equal(np, a, b, what=f"[scheduler] W=100 {label} [{i}] card vs cpu")
        if label != "max_rounds" and any(
                r.result != tasks.FibWorkload(**SCHED_SMALL).expected_result() for r in rg):
            raise SystemExit(f"[scheduler] W=100 {label}: not exact")
        print(f"[scheduler] W=100 {label}: rounds {[r.rounds for r in rg]} successes "
              f"{[r.successes for r in rg]} result {[r.result for r in rg]}; card "
              f"{dt:.3f} s, cpu {dt_c:.3f} s in a worker process, card == cpu in every "
              f"field")
    print(f"[scheduler] steal_compact launches, each grid counted from 0 just "
          f"before it, {subrounds} a loop iteration: {launches}")

    # (d) the kernel against its plain version at the grids' rows
    rs = np.random.default_rng(20261025)
    kern = {"scheduler_main_path_device_ms": k_ms / k_n}
    err = 0
    for tag, points in (("scheduler_", len(sched_grid("FIB_STEADY"))),
                        ("scheduler_fig3_", len(sched_grid("FIB")))):
        rows = points * SCHED_W
        r = _steal_compact_at(torch, ops, ref,
                              _export_inputs(torch, np, ref, rs, rows, SCHED_CAP),
                              ref.GRANT_WIDTH)
        err = max(err, r["max_abs_err"])
        kern.update({f"{tag}{k}": r[k] for k in (
            "ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        print(f"[scheduler] steal_compact at {rows} rows, C={SCHED_CAP}: exact; device "
              f"per launch: kernel {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
              f"library None, bound {r['bound_ms']:.6f} ms ({r['bound_by']}, "
              f"{r['bytes']} bytes); eager wrapper call {r['call_ms']:.6f} ms")
    kern["max_abs_err"] = err
    return launches, kern


SERVE_BATCH, SERVE_NEW = 8, 64
# the kernels' symbols in a profile, by wrapper name (the serving paths run
# both attention kernels in bf16, through their tensor-core kernels, and
# `wkv6` and `rglru` through their sequence kernels in prefill and their
# per-step or per-channel kernels in decode)
KERNEL_SYMBOLS = {"flash_attention": ("flash_attention_wgmma_kernel",),
                  "decode_attention": ("decode_attention_mma_kernel",),
                  "wkv6": ("wkv6_seq_kernel", "wkv6_step_kernel"),
                  "rglru": ("rglru_tma_kernel", "rglru_kernel")}


def _greedy_run(torch, model, cfg, params, prompts, cache_len, feed=None):
    """Prefill `prompts`, then SERVE_NEW - 1 decode steps of `model` (a
    `ModelFns` with `prefill` and `decode_step`). Step i is fed `feed[:, i]`,
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


def _path_launches(cfg):
    """(launches in one prefill, launches in one decode step) by kernel,
    from the model's blocks: an attention block runs `flash_attention` in
    prefill and `decode_attention` in decode, a recurrent block `rglru` and
    an rwkv block `wkv6` in both."""
    kinds = cfg.block_kinds()
    n_att, n_rec, n_rwkv = (kinds.count(k) for k in ("attn", "rec", "rwkv"))
    prefill = {"flash_attention": n_att, "rglru": n_rec, "wkv6": n_rwkv}
    step = {"decode_attention": n_att, "rglru": n_rec, "wkv6": n_rwkv}
    return ({k: n for k, n in prefill.items() if n},
            {k: n for k, n in step.items() if n})


def phase_serve(torch, np, ops, ref, tag: str, arch: str, prompt_len: int, note: str = ""):
    """Serve `arch` at full width and depth on the card through the serving
    entry point (random weights from seed 0): SERVE_BATCH requests of
    `prompt_len` tokens and SERVE_NEW new tokens, counting every kernel's
    launches from 0 and requiring exactly the model's (`_path_launches`);
    the same inputs then run teacher-forced through the plain versions of
    the path's kernels, every step's logits within LOGIT_TOL; prefill and
    decode rates (the launches of each half asserted on their own), peak
    device memory beside the allocation before the run, and the device's
    busy share and top kinds of device time from a profile. Returns
    (main-path launches, {(kernel, "prefill" or "decode"): device ms per
    launch in the profile})."""
    from unittest import mock

    from repro_torch.models import registry
    from repro_torch.runtime import serve_loop

    cfg = registry.get_config(arch)
    fns = registry.get_fns(cfg)
    per_prefill, per_step = _path_launches(cfg)
    kernels = sorted(set(per_prefill) | set(per_step))
    kinds = cfg.block_kinds()
    t0 = time.perf_counter()
    params = fns.init(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers "
          f"({', '.join(f'{kinds.count(k)} {k}' for k in dict.fromkeys(kinds))}), "
          f"d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} kv, hd {cfg.hd}, "
          f"window {cfg.window}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.norm}, "
          f"{cfg.dtype}; {n_params} parameters in the tree (config count "
          f"{cfg.n_params()}{note}), random from seed 0, made in "
          f"{time.perf_counter() - t0:.3f} s")
    sc = serve_loop.ServeConfig(max_new_tokens=SERVE_NEW, prompt_len=prompt_len,
                                cache_len=prompt_len + SERVE_NEW + 8)
    ring = min(sc.cache_len, cfg.window) if cfg.window else sc.cache_len
    holds = (f"{ring} cache slots" if "decode_attention" in per_step
             else "a fixed-size state")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, prompt_len)), device="cuda")
    # warm-up: cuBLAS handles, the kernels' libraries, the allocator
    serve_loop.serve_requests(cfg, params, serve_loop.ServeConfig(
        max_new_tokens=2, prompt_len=prompt_len, cache_len=sc.cache_len), prompts)
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
    want = {k: per_prefill.get(k, 0) + per_step.get(k, 0) * (SERVE_NEW - 1)
            for k in kernels}
    print(f"[{tag}] serve_requests: {SERVE_BATCH} x {prompt_len}-token prompts, "
          f"cache_len {sc.cache_len} ({holds}), {info['decoded']} tokens in "
          f"{wall:.3f} s ({info['decoded'] / wall:.2f} tokens/s end to end); launches "
          f"{counts}; peak device memory {peak} bytes ({before} allocated before "
          f"the run, the weights and what earlier phases hold)")
    for name in ops.LAUNCHES:
        if counts[name] != want.get(name, 0):
            raise SystemExit(f"{tag}: {name} launched {counts[name]} times, "
                             f"expected {want.get(name, 0)}")
    if tuple(served.shape) != (SERVE_BATCH, SERVE_NEW):
        raise SystemExit(f"{tag}: output shape {tuple(served.shape)}")

    # kernel path, greedy, and the plain versions of the path's kernels
    # teacher-forced on its tokens: every step's logits compared
    greedy_k, logits_k = _greedy_run(torch, fns, cfg, params, prompts, sc.cache_len)
    reproduced = bool(torch.equal(_served_view(torch, greedy_k, sc.eos_id), served))
    with contextlib.ExitStack() as plain:
        for name in kernels:
            plain.enter_context(mock.patch.object(ops, name, getattr(ref, name)))
        greedy_p, logits_p = _greedy_run(torch, fns, cfg, params, prompts,
                                         sc.cache_len, feed=greedy_k)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits_k.float()).all()):
        raise SystemExit(f"{tag}: non-finite logits on the kernel path")
    diff = (logits_k.float() - logits_p.float()).abs()
    step_err = diff.amax(dim=(1, 2)).tolist()
    agree = float((greedy_k == greedy_p).float().mean())
    print(f"[{tag}] kernel vs plain path ({', '.join(kernels)}), teacher-forced: "
          f"max abs logit difference prefill {step_err[0]:.6f}, decode steps max "
          f"{max(step_err[1:]):.6f} (tolerance {LOGIT_TOL}); mean abs "
          f"{float(diff.mean()):.6f}; |logit| max {float(logits_k.abs().max()):.4f}; "
          f"greedy-token agreement {agree:.6f} over {greedy_k.numel()} tokens; "
          f"the kernel rerun reproduces the served tokens: {reproduced}")
    if max(step_err) > LOGIT_TOL:
        raise SystemExit(f"{tag}: kernel path and plain path disagree")
    del logits_k, logits_p, diff

    # rates: prefill, and decode steps fed the greedy tokens
    def prefill():
        return fns.prefill(params, cfg, prompts, sc.cache_len)

    def decode(cache, pos, n=SERVE_NEW - 1):
        for i in range(n):
            _, cache, pos = fns.decode_step(params, cfg, greedy_k[:, i].long(),
                                            cache, pos)

    pre_s, dec_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, cache, pos = prefill()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_pre = dict(ops.LAUNCHES)
        decode(cache, pos)
        torch.cuda.synchronize()
        n_dec = {k: ops.LAUNCHES[k] - n_pre[k] for k in kernels}
        if (n_pre != {k: per_prefill.get(k, 0) for k in ops.LAUNCHES}
                or n_dec != {k: per_step.get(k, 0) * (SERVE_NEW - 1) for k in kernels}):
            raise SystemExit(f"{tag}: launches {n_pre} in the prefill, {n_dec} in "
                             f"the decode steps")
        pre_s.append(t1 - t0)
        dec_s.append((time.perf_counter() - t1) / (SERVE_NEW - 1))
    pre, dec = sorted(pre_s)[1], sorted(dec_s)[1]
    print(f"[{tag}] launches {per_prefill} in the prefill, {per_step} in each of the "
          f"{SERVE_NEW - 1} decode steps; prefill {SERVE_BATCH}x{prompt_len}: "
          f"{pre * 1e3:.3f} ms ({SERVE_BATCH * prompt_len / pre:.2f} tokens/s); decode "
          f"{dec * 1e3:.3f} ms/step ({SERVE_BATCH / dec:.2f} tokens/s) at batch "
          f"{SERVE_BATCH}, {holds} (median of 3)")

    # where the time goes: one prefill and 16 decode steps under the profiler
    profiled = {}
    n_prof = min(16, SERVE_NEW - 1)
    for what, fn in (("prefill", prefill),
                     ("decode", lambda: decode(cache, pos, n_prof))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy, n_dev, by_name = _profile(torch, fn)
        shares = []
        for name in (per_prefill if what == "prefill" else per_step):
            hits = [v for k, v in by_name.items()
                    if any(sym + "<" in k or sym + "(" in k for sym in KERNEL_SYMBOLS[name])]
            if not hits:
                raise SystemExit(f"profile of {tag} {what}: no {name} kernel seen")
            k_ms, k_n = sum(ms for ms, _ in hits), max(c for _, c in hits)
            profiled[(name, what)] = k_ms / k_n
            shares.append(f"{name} {k_n}x, {k_ms / k_n * 1e3:.3f} us each, "
                          f"{k_ms / busy:.4f} of the busy time")
        print(f"[profile] {tag} {what}{f' x{n_prof}' if what == 'decode' else ''}: "
              f"device busy {busy:.3f} ms of {wall_ms:.3f} ms wall (busy share "
              f"{busy / wall_ms:.4f}); {n_dev} device activities"
              f"{f' ({n_dev / n_prof:.1f} a step)' if what == 'decode' else ''}; "
              + "; ".join(shares))
        for kname, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"[profile]   {ms:9.3f} ms {cnt:7d}x {kname[:90]}")
    return counts, profiled


def phase_simulate_serving(np):
    """The slot-level serving simulation: card == CPU on the launcher's
    request lengths."""
    from repro_torch.runtime import serve_loop

    rng = np.random.default_rng(0)
    lens = np.minimum((rng.pareto(1.2, (4, 8 * 4)) * 16 + 4), 64).astype(np.int32)
    sim_cfg = serve_loop.ServeConfig(batch_slots=8, n_shards=4)
    t0 = time.perf_counter()
    on_card = serve_loop.simulate_serving(None, sim_cfg, lens)
    t_card = time.perf_counter() - t0
    on_cpu = serve_loop.simulate_serving(None, sim_cfg, lens, device="cpu")
    if on_card != on_cpu:
        raise SystemExit(f"simulate_serving: card {on_card} != cpu {on_cpu}")
    print(f"[serve] simulate_serving card == cpu: occupancy "
          f"{on_card.occupancy:.6f} moved={on_card.moved} steps={on_card.steps} "
          f"completed={on_card.completed} (card {t_card:.3f} s)")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# the main path's phase of a checkout, run in that checkout's directory
_MAIN_ONLY = ("import sys, numpy as np, torch; sys.path.insert(0, 'src'); "
              "import chip_smoke as c; "
              "from repro_torch.core import simulator as sim, tasks, topology as topo; "
              "from repro_torch.kernels import ops; "
              "c.phase_main_path(torch, np, sim, topo, tasks, ops)")


def main_path_turns(parent: str) -> int:
    """The main-path phase of the checkout at `parent` and of this one in
    turns — parent, this, this, parent — each in its own process."""
    here = Path(__file__).resolve().parent
    for tag, root in (("parent", parent), ("this", here), ("this", here),
                      ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", _MAIN_ONLY], cwd=root,
                             capture_output=True, text=True, timeout=900)
        for line in out.stdout.splitlines():
            print(f"[turns {tag}] {line}", flush=True)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
    return 0


def main() -> int:
    import gc

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
    seq_only = _start_wkv6_seq_only(build)
    phase_build(build)
    kern, floor = phase_kernels(torch, np, ops, ref, deque, tasks)
    kern.update(phase_attention(torch, ops, ref))
    kern.update(phase_wkv6(torch, ops, ref, build, seq_only))
    kern.update(phase_rglru(torch, ops, ref, build))
    print(f"[kernels] rglru decode: bound {kern['rglru']['decode_bound_ms']:.6f} ms, "
          f"its bound or the launch floor, whichever is larger: "
          f"{max(kern['rglru']['decode_bound_ms'], floor):.6f} ms")
    # main-path launches by kernel and path, each path's counts read just
    # after it ran from counts set to 0 just before it
    launches, profiled, main_run, main_ms = phase_main_path(torch, np, sim, topo, tasks, ops)
    by_path = {k: {"main": n} for k, n in launches.items()}
    phase_drained(torch, np, sim, topo, tasks, ops)
    sweep_launches, kern["steal_compact"]["sweep_main_path_device_ms"] = phase_sweep(
        torch, np, sim, topo, tasks, ops, main_run)
    for name, n in sweep_launches.items():
        by_path[name]["sweep"] = n
    by_path["steal_compact"]["crossover"] = phase_crossover(torch, ops)
    fault_launches, da_tc = phase_faults(torch, np, sim, topo, tasks, ops, ref, deque,
                                         main_run, main_ms)
    for name, n in fault_launches.items():
        by_path[name]["faults"] = n
    link_launches, link = phase_linkstate(torch, np, sim, ops, main_ms)
    for name, n in link_launches.items():
        by_path[name]["linkstate"] = n
    for name, n in phase_trace(torch, np, sim, topo, tasks, ops, main_run, main_ms,
                               link).items():
        by_path[name]["trace"] = n
    arr_launches, da_arr = phase_arrivals(torch, np, sim, topo, tasks, ops, ref, deque,
                                          main_ms, link)
    for name, n in arr_launches.items():
        by_path[name]["arrivals"] = n
    sched_launches_, sched_kern = phase_scheduler(torch, np, ops, ref)
    by_path["steal_compact"].update(sched_launches_)
    kern["steal_compact"]["max_abs_err"] = max(kern["steal_compact"]["max_abs_err"],
                                               sched_kern.pop("max_abs_err"))
    kern["steal_compact"].update(sched_kern)
    del link
    kern["deque_apply"].update({f"faults_{k}": da_tc[k] for k in (
        "ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "lanes")})
    kern["deque_apply"].update({f"arrivals_{k}": da_arr[k] for k in (
        "ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "lanes")})
    kern["deque_apply"]["max_abs_err"] = max(kern["deque_apply"]["max_abs_err"],
                                             da_tc["max_abs_err"], da_arr["max_abs_err"])
    # the serving paths, one model at a time (each frees its weights)
    serving = {}
    for tag, arch, prompt_len, note in (
            ("serve", "qwen2-0.5b", 512, ""),
            ("serve_rwkv6", "rwkv6-1.6b", 512,
             ": it counts the channel mix as 3·D·d_ff, the tree holds 2·D·d_ff + D²"),
            ("serve_hybrid", "recurrentgemma-9b", 2560,
             ": it leaves out the gates' wa and wx")):
        counts, prof = phase_serve(torch, np, ops, ref, tag, arch, prompt_len, note)
        serving[tag] = prof
        for name, _ in prof:
            by_path.setdefault(name, {})[tag] = counts[name]
        gc.collect()
        torch.cuda.empty_cache()
        if tag == "serve":
            phase_simulate_serving(np)
    profiled["flash_attention"] = serving["serve"][("flash_attention", "prefill")]
    profiled["decode_attention"] = serving["serve"][("decode_attention", "decode")]
    profiled["wkv6"] = serving["serve_rwkv6"][("wkv6", "prefill")]
    kern["wkv6"]["main_path_decode_device_ms"] = serving["serve_rwkv6"][("wkv6", "decode")]
    hybrid = serving["serve_hybrid"]
    kern["flash_attention"]["hd256_main_path_device_ms"] = hybrid[("flash_attention", "prefill")]
    kern["decode_attention"]["hd256_main_path_device_ms"] = hybrid[("decode_attention", "decode")]
    profiled["rglru"] = hybrid[("rglru", "prefill")]
    kern["rglru"]["main_path_decode_device_ms"] = hybrid[("rglru", "decode")]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[total] {time.perf_counter() - t_start:.3f} s")
    print(smi)
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": replaces, "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name]["library_ms"],
         "call_ms": kern[name]["call_ms"],
         "main_path_device_ms": profiled[name],
         **{k: v for k, v in kern[name].items()
            if k.startswith(("decode_", "main_", "hd256_", "fp32_", "sweep_", "faults_",
                              "width4_", "arrivals_", "scheduler_"))
            and k not in ("hd256_bytes", "hd256_ops")}}
        for name, replaces in (
            ("steal_compact", "src/repro/kernels/steal_compact.py:44"),
            ("deque_apply", "src/repro/kernels/deque_apply.py:42"),
            ("flash_attention", "src/repro/kernels/flash_attention.py:79"),
            ("decode_attention", "src/repro/kernels/decode_attention.py:63"),
            ("wkv6", "src/repro/kernels/rwkv6_scan.py:57"),
            ("rglru", "src/repro/kernels/rglru_scan.py:55"))]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turns"] and len(sys.argv) == 3:
        sys.exit(main_path_turns(sys.argv[2]))
    if len(sys.argv) > 1:
        sys.exit(f"usage: {sys.argv[0]} [--turns PARENT_CHECKOUT]")
    sys.exit(main())

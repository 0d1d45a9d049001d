"""Wrappers of the hand-written CUDA kernels.

A wrapper runs its kernel's plain PyTorch version (`ref`) when its tensors
lie on the CPU, and launches the CUDA kernel when they lie on the card —
raising on a bad input, a failed build or a failed launch, never falling
back. `LAUNCHES` counts kernel launches by name: a wrapper adds one right
after its kernel launched, and nowhere else, so a run can show that its
path really went through the kernels. Under CUDA graph capture a wrapper
only records its kernel: `recording` takes the capture's counts back out,
and `add_replays` counts the launches of each replay instead.

Training: `flash_attention`, `wkv6` and `rglru` lie on a training forward.
When grad mode is on and an input requires a gradient, each runs inside a
`torch.autograd.Function` whose forward is the kernel (or, on the CPU, the
plain version) as without autograd, and whose backward recomputes the
function through the plain version under autograd from the saved inputs
and returns its gradients — the reference has no backward Pallas kernel
(XLA differentiates its kernels' oracles), and the recompute holds one
call's intermediates at a time. Without such an input a wrapper runs as
it always did.

The meta device (`launch.dryrun`): the four model kernels
(`flash_attention`, `decode_attention`, `wkv6`, `rglru`) take meta tensors
too, through custom operators (`torch.library.custom_op`, namespace
``repro_torch``) whose fake implementation gives the kernel's outputs,
shapes and types alone, with no intermediate (the plain attention would
make an Sq x Sk score matrix, which the kernel never holds), and whose FLOP
formula (`torch.utils.flop_counter.register_flop_formula`) states the work
the kernel does (`flash_work` and the others); the two scans' backward is
one such operator too (`_meta_grads`). They are defined at the first meta
call, count no launch, and are never reached on the CPU or the card.
"""

from __future__ import annotations

import contextlib

import torch

from ..core import stealing
from . import build, ref

LAUNCHES = {"steal_compact": 0, "deque_apply": 0, "flash_attention": 0,
            "decode_attention": 0, "wkv6": 0, "rglru": 0}
# the attention, wkv6 and rglru kernels' element types, by the code their launch takes
_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# decode_attention's tickets, by device: a few counters per (b, kv) pair,
# zero between launches (the block that takes a counter's last ticket sets
# it back to 0), so they are allocated once, before any graph capture, for
# the kernel's largest B * KV
_MAX_PAIRS = 65535
_TICKETS: dict[int, torch.Tensor] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def recording():
    """Wrap a CUDA graph capture. Wrappers called inside it record their
    kernels into the graph instead of launching them, so their counts are
    taken back out of `LAUNCHES` at exit; the yielded dict then holds the
    launches of each kernel in one replay of the graph (`add_replays`
    counts the replays)."""
    before = dict(LAUNCHES)
    per_replay: dict[str, int] = {}
    try:
        yield per_replay
    finally:
        per_replay.update({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        LAUNCHES.update(before)


def add_replays(per_replay: dict, replays: int) -> None:
    """Count the kernel launches of `replays` replays of a CUDA graph whose
    capture recorded `per_replay[name]` launches of each kernel."""
    for k, n in per_replay.items():
        LAUNCHES[k] += n * replays


def _check(name: str, t: torch.Tensor, shape: tuple,
           dtype: torch.dtype = torch.int32) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned tensor")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _plain_grads(ctx, plain, grads):
    """The gradients of `plain` (the kernel's plain version) at the saved
    inputs, for the outputs' gradients `grads` (None where an output had
    none): `plain` recomputed under autograd. One entry an input, None
    where none is needed."""
    inputs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        outs = plain(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    wanted = [t for t in inputs if t is not None and t.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                   [g for _, g in pairs], allow_unused=True)
               if pairs and wanted else [None] * len(wanted))
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in inputs)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _flash_attention(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        def plain(q, k, v):
            return ref.flash_attention(q, k, v, causal=ctx.causal, window=ctx.window)
        return _plain_grads(ctx, plain, (g,)) + (None, None)


class _Wkv6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state)
        return _wkv6(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, g_out, g_state):
        if g_out is not None and g_out.device.type == "meta":
            return _meta_grads(ctx, "wkv6", g_out)
        return _plain_grads(ctx, ref.wkv6, (g_out, g_state))


class _Rglru(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, i, lam, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, r, i, lam, h0)
        return _rglru(x, r, i, lam, h0)

    @staticmethod
    def backward(ctx, g_h, g_last):
        if g_h is not None and g_h.device.type == "meta":
            return _meta_grads(ctx, "rglru", g_h)
        return _plain_grads(ctx, ref.rglru, (g_h, g_last))


def _meta_grads(ctx, name: str, g):
    """The scans' gradients on the meta device (the dry run): one custom
    operator (`<name>_grads`) of the inputs' shapes, counted at twice the
    forward's FLOPs (`wkv6_work`, `rglru_work`). The card recomputes the
    plain version under autograd, a sequential scan of S steps; counting
    it op by op takes tens of minutes a cell."""
    ins = [torch.empty(0, device="meta") if t is None else t for t in ctx.saved_tensors]
    grads = _meta_ops()[f"{name}_grads"](*ins, g)
    return tuple(gr if t is not None and need else None
                 for gr, t, need in zip(grads, ctx.saved_tensors, ctx.needs_input_grad))


# --------------------------------------------------------------------------- #
# The meta path (`launch.dryrun`)
# --------------------------------------------------------------------------- #
def flash_work(B, KV, G, Sq, Sk, hd, causal, window) -> int:
    """FLOPs of `flash_attention`: the QK and PV products, 4·hd a visible
    (query, key) pair and query head. The kernel visits only the key tiles
    inside the causal and window band (a tile wholly outside it is skipped,
    `csrc/flash_attention.cu`), so its work is the visible pairs plus the
    masked part of the tiles that straddle the band's edges, which this
    count leaves out (the count of `chip_smoke.py`'s bound)."""
    i = torch.arange(Sq, dtype=torch.int64)
    hi = torch.clamp(i + 1, max=Sk) if causal else torch.full_like(i, Sk)
    lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
    pairs = int(torch.clamp(hi - lo, min=0).sum())
    return 4 * hd * B * KV * G * pairs


def decode_work(B, KV, G, T, hd) -> int:
    """FLOPs of `decode_attention` over full caches of T positions (on the
    meta device the lengths are not known): 4·hd a position and query
    head."""
    return 4 * hd * B * KV * G * T


def wkv6_work(B, S, H, hd) -> int:
    """FLOPs of `wkv6` as its sequence kernel takes the steps (`chip_smoke.
    py`'s `_wkv6_work`): per (b, h) and quad of four steps 17·hd² + 71·hd,
    per step left over 5·hd² + 8·hd."""
    quads, single = divmod(S, 4)
    return B * H * (quads * (17 * hd * hd + 71 * hd) + single * (5 * hd * hd + 8 * hd))


def rglru_work(B, S, W) -> int:
    """Operations of `rglru`: ~12 an element (`chip_smoke.py`'s
    `_rglru_work`)."""
    return 12 * B * S * W


_META: dict = {}
# name -> (schema, fake: the kernel's outputs from its inputs' shapes alone)
_META_SCHEMAS = {
    "flash_attention": ("(Tensor q, Tensor k, Tensor v, bool causal, int window) -> Tensor",
                        lambda q, k, v, causal, window: torch.empty_like(q)),
    "decode_attention": ("(Tensor q, Tensor k_cache, Tensor v_cache, Tensor lengths) "
                         "-> Tensor",
                         lambda q, k_cache, v_cache, lengths: torch.empty_like(q)),
    "wkv6": ("(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor? state) "
             "-> (Tensor, Tensor)",
             lambda r, k, v, w, u, state: (
                 r.new_empty(r.shape, dtype=torch.float32),
                 r.new_empty((r.shape[0], r.shape[2], r.shape[3], r.shape[3]),
                             dtype=torch.float32))),
    "rglru": ("(Tensor x, Tensor r, Tensor i, Tensor lam, Tensor? h0) -> (Tensor, Tensor)",
              lambda x, r, i, lam, h0: (
                  x.new_empty(x.shape, dtype=torch.float32),
                  x.new_empty((x.shape[0], x.shape[2]), dtype=torch.float32))),
    # the backward of the two scans (`_meta_grads`): a gradient an input
    "wkv6_grads": ("(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor state, "
                   "Tensor g) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
                   lambda *ts: tuple(torch.empty_like(t) for t in ts[:-1])),
    "rglru_grads": ("(Tensor x, Tensor r, Tensor i, Tensor lam, Tensor h0, Tensor g) "
                    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
                    lambda *ts: tuple(torch.empty_like(t) for t in ts[:-1])),
}


def _meta_only(*args, **kwargs):
    raise RuntimeError("repro_torch's meta operators take meta tensors only")


def _meta_ops() -> dict:
    """The four custom operators of the meta path, defined once a process
    (a second copy of this module finds them defined), each with its fake
    and its FLOP formula."""
    if _META:
        return _META
    from torch.utils.flop_counter import register_flop_formula

    ns = torch.ops.repro_torch
    if not hasattr(ns, "flash_attention"):
        for name, (schema, fake) in _META_SCHEMAS.items():
            torch.library.custom_op(f"repro_torch::{name}", _meta_only, mutates_args=(),
                                    schema=schema).register_fake(fake)

        @register_flop_formula(ns.flash_attention)
        def _(q, k, v, causal, window, *args, **kwargs):
            B, KV, G, Sq, hd = q
            return flash_work(B, KV, G, Sq, k[2], hd, causal, window)

        @register_flop_formula(ns.decode_attention)
        def _(q, k_cache, *args, **kwargs):
            B, KV, G, hd = q
            return decode_work(B, KV, G, k_cache[2], hd)

        @register_flop_formula(ns.wkv6)
        def _(r, *args, **kwargs):
            return wkv6_work(*r)

        @register_flop_formula(ns.rglru)
        def _(x, *args, **kwargs):
            return rglru_work(*x)

        @register_flop_formula(ns.wkv6_grads)
        def _(r, *args, **kwargs):
            return 2 * wkv6_work(*r)

        @register_flop_formula(ns.rglru_grads)
        def _(x, *args, **kwargs):
            return 2 * rglru_work(*x)
    _META.update({name: getattr(ns, name) for name in _META_SCHEMAS})
    return _META


def steal_compact(buf, bot, size, grants, width: int = stealing.GRANT_WIDTH):
    """buf (W, C, 4), bot/size/grants (W,) int32, an export width <=
    GRANT_WIDTH → (stolen (W, width, 4), new_bot, new_size), each grant
    clamped to `width` by the kernel (on the CPU, by the plain version)."""
    if not 1 <= width <= stealing.GRANT_WIDTH:
        raise ValueError(f"export width {width} is outside the steal_compact "
                         f"staging width 1..{stealing.GRANT_WIDTH}")
    if buf.device.type == "cpu":
        return ref.steal_compact(buf, bot, size, grants, width)
    W, C, T = buf.shape
    if T != 4:
        raise ValueError(f"steal_compact: record width must be 4, got {T}")
    for nm, t, shp in (("buf", buf, (W, C, T)), ("bot", bot, (W,)),
                       ("size", size, (W,)), ("grants", grants, (W,))):
        _check(f"steal_compact.{nm}", t, shp)
    lib = build.load("steal_compact")
    compiled = lib.steal_compact_grant_width()
    if compiled != stealing.GRANT_WIDTH:
        raise RuntimeError(f"steal_compact compiled with GRANT_WIDTH={compiled}, "
                           f"expected stealing.GRANT_WIDTH={stealing.GRANT_WIDTH}")
    stolen = torch.empty((W, width, T), dtype=torch.int32, device=buf.device)
    new_bot = torch.empty_like(bot)
    new_size = torch.empty_like(size)
    err = lib.steal_compact_launch(
        buf.data_ptr(), bot.data_ptr(), size.data_ptr(), grants.data_ptr(),
        stolen.data_ptr(), new_bot.data_ptr(), new_size.data_ptr(), W, C, width,
        _stream())
    _raise_on(err, "steal_compact")
    LAUNCHES["steal_compact"] += 1
    return stolen, new_bot, new_size


def deque_apply_(buf, slot, rec, n):
    """In place: buf (W, C, 4), slot (W, L), rec (W, L, 4), n (W,) int32 →
    `buf` itself, with lanes l < n[w] committed in lane order (a slot
    outside [0, C) writes nothing, a row with n = 0 is not touched)."""
    if buf.device.type == "cpu":
        return ref.deque_apply_(buf, slot, rec, n)
    W, C, T = buf.shape
    L = slot.shape[1]
    if T != 4:
        raise ValueError(f"deque_apply: record width must be 4, got {T}")
    for nm, t, shp in (("buf", buf, (W, C, T)), ("slot", slot, (W, L)),
                       ("rec", rec, (W, L, T)), ("n", n, (W,))):
        _check(f"deque_apply.{nm}", t, shp)
    lib = build.load("deque_apply")
    err = lib.deque_apply_launch(buf.data_ptr(), slot.data_ptr(), rec.data_ptr(),
                                 n.data_ptr(), W, C, L, _stream())
    _raise_on(err, "deque_apply")
    LAUNCHES["deque_apply"] += 1
    return buf


def deque_apply(buf, slot, rec, n):
    """`deque_apply_` into a copy of `buf`: a new buffer, `buf` untouched."""
    return deque_apply_(buf.clone(), slot, rec, n)


def _check_attention(name: str, lib, q: torch.Tensor, G: int):
    """The element type, head dim and group size the kernel `name` takes:
    each head dim the library was built for, with its largest group."""
    if q.dtype not in _FLOAT_CODES:
        raise ValueError(f"{name}: expected float32 or bfloat16, got {q.dtype}")
    hd = q.shape[-1]
    max_g = getattr(lib, f"{name}_max_group")(hd)
    if max_g == 0:
        raise ValueError(f"{name}: the kernel was not built for head dim {hd}")
    if not 1 <= G <= max_g:
        raise ValueError(f"{name}: the kernel takes 1..{max_g} query heads per "
                         f"KV head, got {G}")


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (B, KV, G, Sq, hd), k and v (B, KV, Sk, hd) → (B, KV, G, Sq, hd):
    causal (or not) attention over positions from 0, within `window`
    positions when window > 0. Differentiable (see the module docstring)."""
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _flash_attention(q, k, v, causal, window)


def _flash_attention(q, k, v, causal: bool, window: int):
    if q.device.type == "meta":
        return _meta_ops()["flash_attention"](q, k, v, bool(causal), int(window))
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    B, KV, G, Sq, hd = q.shape
    Sk = k.shape[2]
    for nm, t, shp in (("q", q, (B, KV, G, Sq, hd)), ("k", k, (B, KV, Sk, hd)),
                       ("v", v, (B, KV, Sk, hd))):
        _check(f"flash_attention.{nm}", t, shp, q.dtype)
    lib = build.load("flash_attention")
    _check_attention("flash_attention", lib, q, G)
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    out = torch.empty_like(q)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * KV, G,
        Sq, Sk, int(causal), int(window), hd, _FLOAT_CODES[q.dtype], _stream())
    _raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q, k_cache, v_cache, lengths):
    """q (B, KV, G, hd), caches (B, KV, T, hd), lengths (B,) int32 →
    (B, KV, G, hd): each row attends to the first lengths[b] positions of
    its cache."""
    if q.device.type == "meta":
        return _meta_ops()["decode_attention"](q, k_cache, v_cache, lengths)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths)
    B, KV, G, hd = q.shape
    T = k_cache.shape[2]
    for nm, t, shp in (("q", q, (B, KV, G, hd)), ("k_cache", k_cache, (B, KV, T, hd)),
                       ("v_cache", v_cache, (B, KV, T, hd))):
        _check(f"decode_attention.{nm}", t, shp, q.dtype)
    _check("decode_attention.lengths", lengths, (B,))
    lib = build.load("decode_attention")
    _check_attention("decode_attention", lib, q, G)
    if B * KV > _MAX_PAIRS:
        raise ValueError(f"decode_attention: at most {_MAX_PAIRS} (b, kv) pairs, "
                         f"got {B * KV}")
    code = _FLOAT_CODES[q.dtype]
    # the partials (acc, then m and l), one allocation
    n_scratch = lib.decode_attention_scratch_floats(B, KV, G, T, hd, code)
    if n_scratch < 0:
        raise ValueError(f"decode_attention: scratch for B={B} KV={KV} G={G} T={T} "
                         f"does not fit an int")
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=q.device)
    tickets = _TICKETS.get(q.device.index)
    if tickets is None:
        tickets = torch.zeros((_MAX_PAIRS * lib.decode_attention_tickets_per_pair(),),
                              dtype=torch.int32, device=q.device)
        _TICKETS[q.device.index] = tickets
    out = torch.empty_like(q)
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        scratch.data_ptr(), tickets.data_ptr(), out.data_ptr(), B, KV, G, T, hd,
        code, _stream())
    _raise_on(err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out


def wkv6(r, k, v, w, u, state=None):
    """r, k, v (B, S, H, hd) of one type (float32 or bfloat16), w (B, S, H,
    hd), u (H, hd), state (B, H, hd, hd) or None (zeros), all float32 →
    (out (B, S, H, hd), final state (B, H, hd, hd)) float32: the RWKV-6
    recurrence of `ref.wkv6`, any S >= 1. bf16 r, k, v are taken as they
    come and converted to fp32 inside the kernel, which is exact.
    Differentiable (see the module docstring)."""
    if _wants_grad(r, k, v, w, u, state):
        return _Wkv6.apply(r, k, v, w, u, state)
    return _wkv6(r, k, v, w, u, state)


def _wkv6(r, k, v, w, u, state):
    if r.device.type == "meta":
        return tuple(_meta_ops()["wkv6"](r, k, v, w, u, state))
    if r.device.type == "cpu":
        return ref.wkv6(r, k, v, w, u, state)
    B, S, H, hd = r.shape
    if S < 1:
        raise ValueError(f"wkv6: expected S >= 1, got {S}")
    if r.dtype not in _FLOAT_CODES:
        raise ValueError(f"wkv6: expected float32 or bfloat16 r, k, v, got {r.dtype}")
    for nm, t, shp, dt in (("r", r, (B, S, H, hd), r.dtype), ("k", k, (B, S, H, hd), r.dtype),
                           ("v", v, (B, S, H, hd), r.dtype),
                           ("w", w, (B, S, H, hd), torch.float32),
                           ("u", u, (H, hd), torch.float32)):
        _check(f"wkv6.{nm}", t, shp, dt)
    if state is not None:
        _check("wkv6.state", state, (B, H, hd, hd), torch.float32)
    lib = build.load("wkv6")
    if hd != lib.wkv6_head_dim():
        raise ValueError(f"wkv6: the kernel takes head dim {lib.wkv6_head_dim()}, "
                         f"got {hd}")
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    final = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    err = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), out.data_ptr(),
        final.data_ptr(), B, S, H, _FLOAT_CODES[r.dtype], _stream())
    _raise_on(err, "wkv6")
    LAUNCHES["wkv6"] += 1
    return out, final


def rglru(x, r, i, lam, h0=None):
    """x, r, i (B, S, W) of one type (float32 or bfloat16), lam (W,) float32,
    h0 (B, W) float32 or None (zeros) → (h (B, S, W), final h (B, W)) float32:
    the RG-LRU recurrence of `ref.rglru`, any S >= 1. Differentiable (see the
    module docstring)."""
    if _wants_grad(x, r, i, lam, h0):
        return _Rglru.apply(x, r, i, lam, h0)
    return _rglru(x, r, i, lam, h0)


def _rglru(x, r, i, lam, h0):
    if x.device.type == "meta":
        return tuple(_meta_ops()["rglru"](x, r, i, lam, h0))
    if x.device.type == "cpu":
        return ref.rglru(x, r, i, lam, h0)
    B, S, W = x.shape
    if S < 1:
        raise ValueError(f"rglru: expected S >= 1, got {S}")
    for nm, t in (("x", x), ("r", r), ("i", i)):
        _check(f"rglru.{nm}", t, (B, S, W), x.dtype)
    if x.dtype not in _FLOAT_CODES:
        raise ValueError(f"rglru: expected float32 or bfloat16, got {x.dtype}")
    _check("rglru.lam", lam, (W,), torch.float32)
    if h0 is not None:
        _check("rglru.h0", h0, (B, W), torch.float32)
    lib = build.load("rglru")
    out = torch.empty((B, S, W), dtype=torch.float32, device=x.device)
    h_out = torch.empty((B, W), dtype=torch.float32, device=x.device)
    err = lib.rglru_launch(
        x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(),
        None if h0 is None else h0.data_ptr(), out.data_ptr(), h_out.data_ptr(),
        B, S, W, _FLOAT_CODES[x.dtype], _stream())
    _raise_on(err, "rglru")
    LAUNCHES["rglru"] += 1
    return out, h_out

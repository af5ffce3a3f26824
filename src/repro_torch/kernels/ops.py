"""Dispatch to the attention kernels: the CUDA kernel for a CUDA tensor, the
plain PyTorch version for a CPU tensor.

Counterpart of the JAX package's ``kernels/ops.py``. A CUDA tensor always
launches the hand-written kernel (``csrc/*.cu``, built at first use by
``kernels/build.py``) or raises: it never reaches the plain version. The
kernels mask the ragged end of a sequence themselves (key index >= S reads
nothing; flash masks key index >= kv_len), so no operand is copied to pad
it to a block size. ``mtp_attention`` takes its (pos, depth) metadata per
row, (B, M); shared (M,) metadata is broadcast. ``paged_decode_attention``
reads K/V and positions from a shared page pool through a per-row block
table; its plain version gathers each row's pages into a contiguous view.

The bfloat16 decode and paged decode kernels split the cache slots across
blocks (split-K); ``decode_split`` chooses the split, and the wrapper
allocates the partials' scratch. The MTP kernel walks index lists of each
row's keys (``mtp_key_lists``), which its wrapper builds on the device once
per call.

``launches`` counts kernel calls per kernel (a split decode call, its
combine pass included, counts once), so a run can show that the serving
path went through the kernels; ``reset_launches`` zeroes it. The
plain versions stay callable as ``*_plain`` for the card tests and the
chip smoke test, which hold each kernel against its plain version.

The wrappers take full tensors only, the boundary the JAX package's
``paged_decode_attention(mesh=)`` pins. Under a storage-sharded engine
K/V reach them only through ``sharding.utils.kv_full``
(``models.transformer.cache_phase``), which gathers a layer's slices and
refuses a tensor that is not this rank's slice; the wrappers' own shape
checks refuse a head_dim slice (head_dim against q's).

A meta tensor (the dry-run's) takes neither the kernel nor its plain
version: the call returns the kernel's output shapes and counts its FLOPs
(``meta_flops``), as a kernel that builds no score matrix would.

``outside_graph(name, ...)`` calls this module's ``name`` through the
module's attribute, so a wrapper put on it sees the call. While a forward
is captured as a CUDA graph in pieces (``serving/verify_graph.py``, under
``graph_split``), such a call is left out of the graph and made again,
eagerly, at every replay, writing the tensors it first returned
(``out=``): ``models.transformer.cache_phase`` makes the paged call so.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.masks import mtp_mask_predicate
from repro_torch.kernels import build
from repro_torch.models import layers as L

INT32_MAX = 2 ** 31 - 1

launches: Dict[str, int] = {"decode_attention": 0,
                            "paged_decode_attention": 0,
                            "flash_attention": 0, "mtp_attention": 0}

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128, 256)


# the FLOPs of the attention calls made on the meta device, per kernel
meta_flops: Dict[str, float] = dict.fromkeys(launches, 0.0)


# while a forward is captured in pieces: takes each ``outside_graph`` call
_split: Optional[Callable] = None


@contextlib.contextmanager
def graph_split(split: Callable):
    """Inside the block, ``outside_graph(name, *args, **kw)`` returns
    ``split(name, args, kw)`` instead of making the call."""
    global _split
    prev, _split = _split, split
    try:
        yield
    finally:
        _split = prev


def outside_graph(name: str, *args, **kw):
    """This module's ``name``(*args, **kw), looked up as the module's
    attribute at each call; under ``graph_split`` handed to its split."""
    if _split is not None:
        return _split(name, args, kw)
    return globals()[name](*args, **kw)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        meta_flops[name] = 0.0


def _meta_attention(name: str, q, kv_heads: int, keys: float,
                    return_stats: bool):
    """An attention call on the meta device (the dry-run's): the output
    (and f32 stats (B, KV, G, T)) as the kernel makes them, no scores, and
    its FLOPs (QK and PV: 4 per query head, key and head-dim element, over
    ``keys`` keys a query) added to ``meta_flops``."""
    B, T, H, hd = q.shape
    meta_flops[name] += 4.0 * B * T * H * hd * keys
    out = torch.empty_like(q)
    if not return_stats:
        return out
    st = (B, kv_heads, H // kv_heads, T)
    return (out, torch.empty(st, dtype=torch.float32, device=q.device),
            torch.empty(st, dtype=torch.float32, device=q.device))


def _device_kind(q: torch.Tensor, k: torch.Tensor) -> str:
    """"cuda" (the kernel), "cpu" (the plain version) or "meta" (the
    dry-run's shapes and FLOPs, ``_meta_attention``). On every device K/V
    must have q's head_dim and a head count that divides q's, so a head_dim
    slice of a sharded engine's K/V is refused before any path runs."""
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"attention on {q.device} is not supported")
    if k.shape[-1] != q.shape[-1] or q.shape[-2] % k.shape[-2]:
        raise ValueError(f"K/V {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: head_dim must match and the "
                         f"K/V heads divide q's")
    return q.device.type


def _check_operands(q, k, v, per_row=True):
    """q (B, T, H, hd) and k/v (B, S, KV, hd), or with per_row False a
    shared pool (NP, page, KV, hd)."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in HEAD_DIMS or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got "
                         f"{q.shape[-1]}/{k.shape[-1]}")
    if (q.dim() != 4 or k.dim() != 4 or q.shape[2] % k.shape[2]
            or k.shape != v.shape or (per_row and q.shape[0] != k.shape[0])):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_int32(q, **named_shapes):
    for name, (t, shape) in named_shapes.items():
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 {shape} on "
                             f"{q.device}")


def _raise_on(lib, err: int, name: str):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.repro_attn_error_string(err).decode()} "
                           f"(cudaError {err})")


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def decode_attention_plain(q, k, v, k_positions, q_positions, *, scale,
                           window=0, softcap=0.0, return_stats=False):
    """Plain version of the decode kernel: q (B,T,H,hd) against k/v
    (B,S,KV,hd) holding absolute positions k_positions (B,S) (-1 = empty),
    queries at q_positions (B,T), scores capped at ``softcap * tanh(s /
    softcap)`` (0: no cap). Returns out (B,T,H,hd), and with return_stats
    the f32 (m, l), each (B, KV, G, T)."""
    mask = L.cache_mask_fn(q_positions, k_positions, window=window)
    out, m, l = L.blocked_attention(q, k, v, scale=scale, mask_fn=mask,
                                    logit_cap=softcap, return_stats=True)
    return (out, m, l) if return_stats else out


# The bfloat16 decode kernel's tiles, mirrors of kBK, kRows and kMaxTiles in
# csrc/decode_splitk.cuh: keys per tile, packed (query, head) rows per
# block at head dims up to 128, key tiles per chunk at most. The launch
# rejects a key or row tile that differs from the kernel's, and a chunk of
# more tiles than it holds.
DECODE_KEY_TILE = 64
DECODE_ROW_TILE = 64
DECODE_MAX_CHUNK_TILES = 256


def decode_row_tile(hd: int) -> int:
    """Packed (query, head) rows a block of the bfloat16 decode kernel
    takes at head dim ``hd`` (``rows_per_block`` in decode_splitk.cuh): 16
    at 256, where the four warps split the columns of one 16-row group, else
    ``DECODE_ROW_TILE``."""
    return DECODE_ROW_TILE // 4 if hd == 256 else DECODE_ROW_TILE


def decode_split(S: int, row_blocks: int, n_sm: int) -> Tuple[int, int]:
    """Split-K of the bfloat16 decode kernel: (splits, chunk). The S cache
    slots are cut into ``splits`` contiguous chunks of ``chunk`` slots (the
    last one may be shorter), ``chunk`` a multiple of the key tile. Each
    split runs ``row_blocks`` blocks (row tiles x batch x KV heads); the
    count aims at about two waves of blocks on ``n_sm`` SMs and is 1 when
    the row blocks alone fill the card."""
    tiles = max(1, -(-S // DECODE_KEY_TILE))
    chunk_tiles = tiles
    if row_blocks < n_sm:   # at least the wanted splits, if tiles allow
        want = -(-2 * n_sm // max(row_blocks, 1))
        chunk_tiles = max(1, tiles // want)
    chunk_tiles = min(chunk_tiles, DECODE_MAX_CHUNK_TILES)
    return -(-tiles // chunk_tiles), chunk_tiles * DECODE_KEY_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_k(q, S, KV):
    """The split of a decode-shaped call over S key slots, q (B, T, H, hd):
    (nsplit, chunk, buf, ptrs), ``decode_split``'s split in bfloat16 (the
    f32 body walks each row's slots in one block). When it splits, ``buf``
    holds the partials (o, m, l) of each (split, row) in one f32 buffer,
    which must outlive the launch, and ``ptrs`` points at them (po, pm,
    pl); else both are None."""
    B, T, H, hd = q.shape
    G = H // KV
    if q.dtype != torch.bfloat16:
        return 1, S, None, [None] * 3
    row_blocks = -(-G * T // decode_row_tile(hd)) * B * KV
    nsplit, chunk = decode_split(S, row_blocks, _sm_count(q.device.index))
    if nsplit == 1:
        return nsplit, chunk, None, [None] * 3
    n = B * KV * nsplit * G * T
    buf = torch.empty(n * (hd + 2), dtype=torch.float32, device=q.device)
    ptrs = [buf.data_ptr(), buf[n * hd:].data_ptr(),
            buf[n * (hd + 1):].data_ptr()]
    return nsplit, chunk, buf, ptrs


def decode_attention(q, k, v, k_positions, q_positions, *, scale, window=0,
                     softcap=0.0, return_stats=False):
    """Decode attention (see ``decode_attention_plain``): the CUDA kernel of
    ``csrc/decode_attention.cu`` for CUDA tensors, split across the cache
    slots by ``decode_split`` in bfloat16."""
    kind = _device_kind(q, k)
    if kind == "meta":
        return _meta_attention("decode_attention", q, k.shape[2], k.shape[1],
                               return_stats)
    if kind == "cpu":
        return decode_attention_plain(q, k, v, k_positions, q_positions,
                                      scale=scale, window=window,
                                      softcap=softcap,
                                      return_stats=return_stats)
    _check_operands(q, k, v)
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    _check_int32(q, k_positions=(k_positions, (B, S)),
                 q_positions=(q_positions, (B, T)))
    out = torch.empty_like(q)
    m = torch.empty((B, KV, H // KV, T), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    nsplit, chunk, buf, scratch = _split_k(q, S, KV)   # buf: alive to here
    lib = build.library("decode_attention")
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_positions.data_ptr(),
        q_positions.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        *scratch, B, T, H, KV, S, hd, float(scale), int(window),
        float(softcap), nsplit, chunk, DECODE_KEY_TILE, decode_row_tile(hd),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    launches["decode_attention"] += 1
    _raise_on(lib, err, "decode_attention")
    return (out, m, l) if return_stats else out


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def paged_decode_attention_plain(q, k_pool, v_pool, pos_pool, block_table,
                                 q_positions, *, scale, window=0,
                                 softcap=0.0, return_stats=False):
    """Plain version of the paged decode kernel: q (B,T,H,hd) against the
    pages each row's block table (B, nb) names in the pool k/v (NP, page,
    KV, hd) with positions pos_pool (NP, page) (-1 = empty). Entries
    outside [0, NP) (-1 = unallocated) are empty. Gathers each row's pages
    into a contiguous (B, nb * page) view and runs the decode plain version
    on it; returns what ``decode_attention_plain`` returns."""
    kpos = L.paged_view(pos_pool, block_table, empty=-1)
    return decode_attention_plain(
        q, L.paged_view(k_pool, block_table),
        L.paged_view(v_pool, block_table), kpos, q_positions, scale=scale,
        window=window, softcap=softcap, return_stats=return_stats)


def paged_decode_attention(q, k_pool, v_pool, pos_pool, block_table,
                           q_positions, *, scale, window=0, softcap=0.0,
                           return_stats=False, out=None):
    """Paged decode attention (see ``paged_decode_attention_plain``): the
    CUDA kernel of ``csrc/paged_decode_attention.cu`` for CUDA tensors,
    which reads the pool through the table and builds no view, split
    across the nb * page slots a row addresses by ``decode_split`` in
    bfloat16, as ``decode_attention`` is. ``out``: the tensors to write
    the result into, as a call of these operands returns them (a tensor,
    or (out, m, l) with ``return_stats``); they are returned."""
    kind = _device_kind(q, k_pool)
    if kind == "meta":
        return _meta_attention("paged_decode_attention", q, k_pool.shape[2],
                               block_table.shape[1] * k_pool.shape[1],
                               return_stats)
    if kind == "cpu":
        got = paged_decode_attention_plain(
            q, k_pool, v_pool, pos_pool, block_table, q_positions,
            scale=scale, window=window, softcap=softcap,
            return_stats=return_stats)
        if out is None:
            return got
        for o, g in zip(out, got) if return_stats else [(out, got)]:
            o.copy_(g)
        return out
    _check_operands(q, k_pool, v_pool, per_row=False)
    B, T, H, hd = q.shape
    NP, page, KV = k_pool.shape[:3]
    nb = block_table.shape[-1]
    _check_int32(q, pos_pool=(pos_pool, (NP, page)),
                 block_table=(block_table, (B, nb)),
                 q_positions=(q_positions, (B, T)))
    stats = (B, KV, H // KV, T)
    if out is None:
        o = torch.empty_like(q)
        m = torch.empty(stats, dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    else:
        o, m, l = out if return_stats else (out, None, None)
        if m is None:
            m = torch.empty(stats, dtype=torch.float32, device=q.device)
            l = torch.empty_like(m)
        if not (o.shape == q.shape and o.dtype == q.dtype and o.is_contiguous()
                and m.shape == l.shape == stats
                and m.dtype == l.dtype == torch.float32
                and m.is_contiguous() and l.is_contiguous()):
            raise ValueError("paged_decode_attention: out does not hold "
                             "this call's result")
    nsplit, chunk, buf, scratch = _split_k(q, nb * page, KV)  # buf: alive
    lib = build.library("paged_decode_attention")
    err = lib.paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pos_pool.data_ptr(), block_table.data_ptr(), q_positions.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), *scratch, B, T, H, KV,
        NP, page, nb, hd, float(scale), int(window), float(softcap), nsplit,
        chunk,
        DECODE_KEY_TILE, decode_row_tile(hd), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    launches["paged_decode_attention"] += 1
    _raise_on(lib, err, "paged_decode_attention")
    return (o, m, l) if return_stats else o


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, *, scale, causal=True, window=0,
                          softcap=0.0, kv_len=0):
    """Plain version of the flash kernel: q (B,Sq,H,hd) against k/v
    (B,Skv,KV,hd) by index, causal and/or sliding-window, optional tanh
    softcap, keys at index >= kv_len masked (0 = all keys real)."""
    kv_len = kv_len or k.shape[1]

    def mask(q_idx, k_idx):
        ok = (k_idx < kv_len)[None, :]
        if causal:
            ok = ok & (q_idx[:, None] >= k_idx[None, :])
        if window > 0:
            ok = ok & ((q_idx[:, None] - k_idx[None, :]) < window)
        return ok

    return L.blocked_attention(q, k, v, scale=scale, mask_fn=mask,
                               logit_cap=softcap)


def flash_attention(q, k, v, *, scale, causal=True, window=0, softcap=0.0,
                    kv_len=0):
    """Flash attention (see ``flash_attention_plain``): the CUDA kernel of
    ``csrc/flash_attention.cu`` for CUDA tensors."""
    kind = _device_kind(q, k)
    if kind == "meta":
        Sq, Skv = q.shape[1], k.shape[1]
        keys = Skv if not causal else (Skv - Sq) + (Sq + 1) / 2
        return _meta_attention("flash_attention", q, k.shape[2],
                               min(keys, window) if window else keys, False)
    if kind == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     window=window, softcap=softcap,
                                     kv_len=kv_len)
    _check_operands(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = build.library("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, KV, hd, float(scale), int(causal), int(window),
        float(softcap), int(kv_len or Skv), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    launches["flash_attention"] += 1
    _raise_on(lib, err, "flash_attention")
    return out


# ---------------------------------------------------------------------------
# MTP attention (drafter training)
# ---------------------------------------------------------------------------

def _mtp_mask_fn(pos: torch.Tensor, depth: torch.Tensor) -> L.MaskFn:
    """The closed-form MTP predicate as a ``blocked_attention`` mask over
    per-row metadata pos/depth (B, M)."""
    def fn(q_idx, k_idx):
        ok = mtp_mask_predicate(depth[:, q_idx], pos[:, q_idx],
                                depth[:, k_idx], pos[:, k_idx])
        return ok[:, None, None]                          # (B,1,1,Sq,Bk)
    return fn


def row_metadata(meta: torch.Tensor, B: int) -> torch.Tensor:
    """(M,) or (B, M) metadata -> contiguous int32 (B, M)."""
    if meta.dim() == 1:
        meta = meta[None].expand(B, meta.shape[0])
    return meta.to(torch.int32).contiguous()


def mtp_attention_plain(q, k, v, pos, depth, *, scale, return_stats=False):
    """Plain version of the MTP kernel: q (B,M,H,hd), k/v (B,M,KV,hd) under
    the closed-form predicate of pos/depth, (M,) or (B,M) int32 (-1 pad).
    Pad rows are zeros. With return_stats also returns the f32 (m, l),
    each (B, KV, G, M)."""
    B = q.shape[0]
    pos, depth = row_metadata(pos, B), row_metadata(depth, B)
    out, m, l = L.blocked_attention(q, k, v, scale=scale,
                                    mask_fn=_mtp_mask_fn(pos, depth),
                                    return_stats=True)
    return (out, m, l) if return_stats else out


def mtp_key_lists(pos: torch.Tensor, depth: torch.Tensor):
    """The MTP kernel's two index lists of each row's keys, from per-row
    int32 pos/depth (B, M): ``order`` (B, 2, M) int64, whose list 0 begins
    with the indices of the depth-0 keys sorted by position and list 1 with
    those of the depth >= 1 keys sorted by anchor pos - depth (ties in index
    order); ``okey`` (B, 2, M) int32 the sort key of each entry; ``counts``
    (B, 2) int32 the entries of each list (what follows them is the other
    keys, under the key INT32_MAX). One stable int32 sort on the device, no
    host sync. A query of anchor a sees, of these, the list-0 entries with
    okey <= a and the list-1 entries with okey == a (and depth <= its
    own)."""
    keys = torch.stack((torch.where(depth == 0, pos, INT32_MAX),
                        torch.where(depth > 0, pos - depth, INT32_MAX)), 1)
    okey, order = torch.sort(keys, dim=-1, stable=True)
    counts = torch.stack(((depth == 0).sum(1), (depth > 0).sum(1)), 1)
    return order, okey, counts.to(torch.int32)


def mtp_attention(q, k, v, pos, depth, *, scale, return_stats=False):
    """MTP attention (see ``mtp_attention_plain``): the CUDA kernel of
    ``csrc/mtp_attention.cu`` for CUDA tensors, which walks the index lists
    of ``mtp_key_lists``."""
    kind = _device_kind(q, k)
    if kind == "meta":      # the predicate keeps about a causal half
        return _meta_attention("mtp_attention", q, k.shape[2],
                               (k.shape[1] + 1) / 2, return_stats)
    if kind == "cpu":
        return mtp_attention_plain(q, k, v, pos, depth, scale=scale,
                                   return_stats=return_stats)
    _check_operands(q, k, v)
    B, M, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[1] != M:
        raise ValueError(f"q has {M} positions, k/v {k.shape[1]}")
    pos, depth = row_metadata(pos, B), row_metadata(depth, B)
    for name, t in (("pos", pos), ("depth", depth)):
        if tuple(t.shape) != (B, M) or t.device != q.device:
            raise ValueError(f"{name} must be (M,) or ({B}, {M}) on {q.device}")
    order, okey, counts = mtp_key_lists(pos, depth)
    out = torch.empty_like(q)
    m = torch.empty((B, KV, H // KV, M), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    lib = build.library("mtp_attention")
    err = lib.mtp_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        depth.data_ptr(), order.data_ptr(), okey.data_ptr(),
        counts.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, M, H, KV, hd, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    launches["mtp_attention"] += 1
    _raise_on(lib, err, "mtp_attention")
    return (out, m, l) if return_stats else out

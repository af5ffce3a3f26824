"""Streaming serving over a TCP socket: newline-delimited JSON in front of
the wall-clock :class:`~repro_torch.serving.streaming.AsyncEngine`.

Counterpart of the JAX package's ``launch/serve_stream.py``, with the same
protocol. The server's process steps the engine and moves small JSON
lines; clients (request shaping, tokenization) live in other processes.

    PYTHONPATH=src python -m repro_torch.launch.serve_stream    # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve_stream --reduced \\
        --device cpu --max-len 64 --max-new 8 --page-size 8     # CPU rehearsal
    PYTHONPATH=src python -m repro_torch.launch.serve_stream --arch \\
        qwen2-1.5b --ckpt results/ckpt --layers 4   # a trained drafter
    PYTHONPATH=src python -m repro_torch.launch.serve_stream --client \\
        --port 8765 --requests 4                                # the client

The server is ``--arch`` (default qwen2-1.5b; every family the
AsyncEngine serves, a VLM or encoder-decoder target with stub frontend
inputs drawn from each prompt at admission) at full width in bfloat16,
seeded random weights, with the ``--layers``-layer drafter: the latest
``drafter_{arch}`` checkpoint under ``--ckpt`` (the training launcher's
output), or seeded random weights when there is none
(``launch.serve.build_engine``); paged KV by default; ``--prefix-cache``,
``--swap host`` and ``--adaptive-k`` turn on the serving policies, and
``--temperature/--top-k/--top-p/--seed`` set the policy of requests that
name none. ``--port 0`` binds a free port (the line the server prints
names it).

Protocol, one JSON object per line both ways. Client to server::

    {"op": "generate", "id": "r1", "prompt": [3, 17, ...],
     "max_new_tokens": 32,            # optional
     "temperature": 0.8, "top_k": 0, "top_p": 1.0, "seed": 7}  # optional
    {"op": "abort", "id": "r1"}
    {"op": "health"}

Server to client::

    {"id": "r1", "event": "tokens", "tokens": [..], "logprobs": [..]}
    {"id": "r1", "event": "done", "n_new": 12, "aborted": false}
    {"event": "health", "queue_depth": 0, ...}
    {"id": "r1", "event": "error", "message": "..."}

A ``tokens`` event carries what one sync committed for the request, stop-
and budget-trimmed. ``id`` is the client's key, scoped per connection. A
dropped connection aborts its requests. The ``--client`` path imports no
torch code.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
from typing import Any, Dict

import numpy as np


def _sampling_from(msg: Dict[str, Any]):
    """The request's SamplingParams from the protocol's fields; None when
    the message sets none (the engine's default applies)."""
    from repro_torch.serving.sampling import SamplingParams
    keys = ("temperature", "top_k", "top_p", "seed", "stop_token_ids")
    if not any(k in msg for k in keys):
        return None
    return SamplingParams(temperature=float(msg.get("temperature", 0.0)),
                          top_k=int(msg.get("top_k", 0)),
                          top_p=float(msg.get("top_p", 1.0)),
                          seed=int(msg.get("seed", 0)),
                          stop_token_ids=tuple(msg.get("stop_token_ids", ())))


class _Connection:
    """One client connection: reads NDJSON ops, runs a pump task per
    generate op, and writes through a lock so streams never interleave
    inside a line."""

    def __init__(self, aeng, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.aeng = aeng
        self.reader = reader
        self.writer = writer
        self.wlock = asyncio.Lock()
        self.handles: Dict[str, Any] = {}
        self.tasks: Dict[str, asyncio.Task] = {}

    async def send(self, obj: Dict[str, Any]) -> None:
        line = (json.dumps(obj) + "\n").encode()
        async with self.wlock:
            self.writer.write(line)
            # a slow client holds back its own connection, never the
            # dispatch task
            await self.writer.drain()

    async def _pump(self, cid: str, handle) -> None:
        """Forward one request's tokens as they stream out, then its done
        event."""
        try:
            try:
                async for tok, lp in handle:
                    toks, lps = [tok], [lp]
                    # and whatever the same sync delivered
                    while True:
                        try:
                            nxt = handle._queue.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                        if nxt is None or isinstance(nxt, BaseException):
                            handle._queue.put_nowait(nxt)
                            break
                        toks.append(nxt[0])
                        lps.append(nxt[1])
                    await self.send({"id": cid, "event": "tokens",
                                     "tokens": toks, "logprobs": lps})
                final = {"id": cid, "event": "done",
                         "n_new": len(handle.request.out_tokens),
                         "aborted": handle.aborted}
            except Exception as e:                   # the engine failed
                final = {"id": cid, "event": "error", "message": repr(e)}
            try:
                await self.send(final)
            except (ConnectionError, RuntimeError):
                pass                                 # the client is gone
        finally:
            self.handles.pop(cid, None)
            self.tasks.pop(cid, None)

    async def handle_op(self, msg: Dict[str, Any]) -> None:
        op = msg.get("op")
        if op == "generate":
            cid = str(msg.get("id"))
            if cid in self.handles:
                await self.send({"id": cid, "event": "error",
                                 "message": "duplicate id"})
                return
            try:
                prompt = np.asarray(msg["prompt"], np.int32)
                handle = await self.aeng.submit(
                    prompt, sampling_params=_sampling_from(msg),
                    max_new_tokens=msg.get("max_new_tokens"))
            except (ValueError, KeyError, TypeError) as e:
                await self.send({"id": cid, "event": "error",
                                 "message": str(e)})
                return
            self.handles[cid] = handle
            self.tasks[cid] = asyncio.get_running_loop().create_task(
                self._pump(cid, handle))
        elif op == "abort":
            cid = str(msg.get("id"))
            handle = self.handles.get(cid)
            # the pump sees the end sentinel and sends "done"
            if handle is None:
                await self.send({"id": cid, "event": "error",
                                 "message": "unknown id"})
            else:
                handle.abort()
        elif op == "health":
            await self.send({"event": "health", **self.aeng.health()})
        else:
            await self.send({"event": "error",
                             "message": f"unknown op {op!r}"})

    async def run(self) -> None:
        try:
            while True:
                line = await self.reader.readline()
                if not line:
                    break
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError as e:
                    await self.send({"event": "error", "message": str(e)})
                    continue
                await self.handle_op(msg)
        except (OSError, RuntimeError):
            # a reset mid-read, or a send on the closed transport: as EOF
            pass
        finally:
            # a vanished client must not hold slots or pages
            for handle in list(self.handles.values()):
                if not handle.done:
                    handle.abort()
            for t in list(self.tasks.values()):
                t.cancel()
            self.writer.close()


async def start_stream_server(aeng, host: str = "127.0.0.1",
                              port: int = 0) -> "asyncio.base_events.Server":
    """Start the NDJSON front end of an AsyncEngine (started or not) and
    return the asyncio Server; its sockets carry the bound port."""
    await aeng.start()

    async def on_client(reader, writer):
        await _Connection(aeng, reader, writer).run()

    return await asyncio.start_server(on_client, host, port)


# ---------------------------------------------------------------------------
# the reference client
# ---------------------------------------------------------------------------
async def _demo_client(host: str, port: int, n_requests: int,
                       max_new: int, vocab: int, temperature: float,
                       seed: int) -> None:
    reader, writer = await asyncio.open_connection(host, port)
    rng = np.random.default_rng(seed)
    for i in range(n_requests):
        req = {"op": "generate", "id": f"r{i}",
               "prompt": rng.integers(0, vocab,
                                      size=int(rng.integers(4, 13))).tolist(),
               "max_new_tokens": max_new}
        if temperature > 0:
            req.update(temperature=temperature, seed=seed + i)
        writer.write((json.dumps(req) + "\n").encode())
    writer.write((json.dumps({"op": "health"}) + "\n").encode())
    await writer.drain()
    got: Dict[str, list] = {}
    done = 0
    while done < n_requests:
        msg = json.loads(await reader.readline())
        if msg.get("event") == "tokens":
            got.setdefault(msg["id"], []).extend(msg["tokens"])
        elif msg.get("event") == "done":
            done += 1
            print(f"{msg['id']}: {msg['n_new']} tokens"
                  + (" (aborted)" if msg["aborted"] else ""))
        elif msg.get("event") == "health":
            print("health:", {k: msg[k] for k in
                              ("queue_depth", "running", "pool_occupancy")})
        elif msg.get("event") == "error":
            print("error:", msg["message"])
            done += 1
    writer.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="the target architecture (every family the "
                         "AsyncEngine serves)")
    ap.add_argument("--reduced", action="store_true",
                    help="the 2-layer CPU-test config instead of full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--mode", default="parallel",
                    choices=("parallel", "ar", "none"))
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--layers", type=int, default=4,
                    help="the drafter's depth (the checkpoint's)")
    ap.add_argument("--ckpt", default="results/ckpt",
                    help="serve the latest drafter_{arch} checkpoint under "
                         "this directory; none there: a random drafter")
    ap.add_argument("--batch", type=int, default=8, help="decode slots")
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--kv-layout", choices=("contiguous", "paged"),
                    default="paged")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="0 = batch * max_len / page_size")
    ap.add_argument("--sync-every", type=int, default=1)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="admit prompts against cached pages of earlier "
                         "streams (paged)")
    ap.add_argument("--swap", choices=("none", "host"), default="none",
                    help="host: preempt to pinned host memory (paged)")
    ap.add_argument("--host-pool-bytes", type=int, default=0,
                    help="host swap budget (0 = unbounded)")
    ap.add_argument("--adaptive-k", action="store_true",
                    help="per-request draft length from the request's own "
                         "acceptance")
    ap.add_argument("--max-pending", type=int, default=0,
                    help="backpressure bound on requests in flight "
                         "(0 = 4 * batch)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="server: the policy of requests that name none; "
                         "client: each request's temperature (0: greedy)")
    ap.add_argument("--top-k", type=int, default=0, help="0 disables")
    ap.add_argument("--top-p", type=float, default=1.0, help="1.0 disables")
    ap.add_argument("--draft-sampling", action="store_true",
                    help="sampled requests draw their drafts from the warped "
                         "drafter distribution")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, and the sampling seed (client: request i "
                         "samples on seed + i)")
    ap.add_argument("--client", action="store_true",
                    help="run the reference NDJSON client against "
                         "--host/--port instead of the server")
    ap.add_argument("--requests", type=int, default=4,
                    help="(client) streamed requests")
    args = ap.parse_args(argv)

    if args.client:
        asyncio.run(_demo_client(args.host, args.port, args.requests,
                                 args.max_new, 128, args.temperature,
                                 args.seed))
        return

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "the NDJSON server over several ranks: the JAX package's server "
            "takes no mesh, so neither does this one (AsyncEngine itself "
            "serves over a mesh: rank 0 decides, the other ranks follow)")
    # the server's imports: the client stays free of torch
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.engine import resolve_device
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.streaming import AsyncEngine

    dev = resolve_device(args.device)
    default = (SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, seed=args.seed)
               if args.temperature > 0 else None)
    eng = build_engine(arch=args.arch, reduced=args.reduced, mode=args.mode,
                       K=args.k, ckpt=args.ckpt, drafter_layers=args.layers,
                       max_new=args.max_new, max_len=args.max_len,
                       batch=args.batch, seed=args.seed, device=dev,
                       kv_layout=args.kv_layout, page_size=args.page_size,
                       pool_pages=args.pool_pages, sampling=default,
                       draft_sampling=args.draft_sampling,
                       prefix_cache=args.prefix_cache, swap=args.swap,
                       host_pool_bytes=args.host_pool_bytes)
    aeng = AsyncEngine(eng, eos_id=args.eos_id, sync_every=args.sync_every,
                       max_pending=args.max_pending or None,
                       adaptive_k=args.adaptive_k)

    async def serve_forever():
        server = await start_stream_server(aeng, args.host, args.port)
        addr = server.sockets[0].getsockname()
        src = eng.drafter_source
        drafter = "" if src is None else (
            f", drafter {src['path']}" if src["source"] == "checkpoint"
            else ", random drafter")
        print(f"streaming NDJSON server on {addr[0]}:{addr[1]} "
              f"({eng.tcfg.arch_id}, {dev}, batch {args.batch}, K {args.k}, "
              f"mode {args.mode}, {args.kv_layout}, max_pending "
              f"{aeng.max_pending}{drafter})", flush=True)
        async with server:
            await server.serve_forever()

    try:
        asyncio.run(serve_forever())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

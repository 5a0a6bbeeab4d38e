"""Serving driver: batched prefill + decode over the served model
(counterpart of ``repro.launch.serve``).

Runs on the card unless ``--device cpu`` is given:
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --batch 2 --prompt-len 16 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \\
        --smoke --device cpu --stats
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-236b --smoke --device cpu   # MLA, shared experts
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-1.5-large-398b --smoke --device cpu   # Mamba hybrid
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch xlstm-350m --smoke --device cpu --prompt-len 40   # xLSTM

Observability, as in the reference: every ``generate`` call records the
serve.requests / serve.tokens counters, the serve.generate_seconds
histogram and the serve.last_tok_per_s gauge in the process-wide obs
registry, with the serve.generate, serve.prefill and serve.decode spans.
``stats()`` is the JSON stats surface; ``--stats`` prints it after the
demo request and ``--stats-port N`` serves it at GET /stats from a
background stdlib HTTP server bound to 127.0.0.1.

The reference keeps one jit-compiled ``decode_step`` per config; PyTorch
runs eagerly, so there is no compile cache to port. Temperature sampling
draws the reference's gumbel noise from the reference's key splits on the
host (``core/prng.py``), never from torch's generators, so a key gives the
reference's tokens.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from time import perf_counter

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.models import decode_step, init_params, prefill

_T_START = time.time()


def _sample(logits: torch.Tensor, temperature: float, key) -> torch.Tensor:
    """argmax(logits / T + gumbel(key)), the reference's
    ``jax.random.categorical``: (B, 1) int64."""
    lg = logits / temperature
    g = prng.gumbel(key, tuple(lg.shape), str(lg.dtype).split(".")[-1])
    g = torch.from_numpy(g).to(device=lg.device, dtype=lg.dtype)
    return (g + lg).argmax(-1, keepdim=True)


@torch.inference_mode()
def generate(cfg, params, batch, prompt_len: int, gen: int, *,
             temperature: float = 0.0, key=None) -> torch.Tensor:
    """Greedy (or, with a temperature and a raw key, sampled) decoding of
    ``gen`` tokens after a batched prefill: (B, gen) int64."""
    B = batch["tokens"].shape[0]
    reg = obs.get_registry()
    t0 = perf_counter()
    with obs.span("serve.generate", batch=B, gen=gen):
        with obs.span("serve.prefill", prompt_len=prompt_len):
            logits, cache = prefill(cfg, params, batch,
                                    cache_len=prompt_len + gen)
        out = []
        with obs.span("serve.decode", gen=gen):
            for i in range(gen):
                if temperature > 0 and key is not None:
                    key, k2 = prng.split(key)
                    tok = _sample(logits[:, -1], temperature, k2)
                else:
                    tok = logits[:, -1].argmax(-1, keepdim=True)
                out.append(tok)
                logits, cache = decode_step(cfg, params, tok, cache,
                                            prompt_len + i)
        toks = torch.cat(out, dim=1)
        if toks.is_cuda:
            torch.cuda.synchronize(toks.device)
    dt = perf_counter() - t0
    reg.counter("serve.requests").inc()
    reg.counter("serve.tokens").inc(B * gen)
    reg.histogram("serve.generate_seconds").observe(dt)
    reg.gauge("serve.last_tok_per_s").set(B * gen / dt if dt else 0.0)
    return toks


def stats() -> dict:
    """The stats surface: uptime + the obs metrics snapshot."""
    return {"uptime_s": round(time.time() - _T_START, 3),
            "metrics": obs.get_registry().snapshot()}


class _StatsHandler(BaseHTTPRequestHandler):
    def do_GET(self):
        if self.path not in ("/stats", "/"):
            self.send_error(404)
            return
        body = json.dumps(stats(), sort_keys=True).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):        # keep request noise off stdout
        pass


def serve_stats(port: int) -> ThreadingHTTPServer:
    """Start the background stats endpoint; returns the server (call
    .shutdown() to stop). Bound to localhost: it reports process metrics,
    it is not a public API."""
    srv = ThreadingHTTPServer(("127.0.0.1", port), _StatsHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Batched prefill + decode (PyTorch port of "
                    "repro.launch.serve).")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stats", action="store_true",
                    help="print the JSON stats snapshot after the request")
    ap.add_argument("--stats-port", type=int, default=0,
                    help="serve GET /stats on 127.0.0.1:PORT (0 = off)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain versions on the CPU")
    device = torch.device(args.device)

    srv = serve_stats(args.stats_port) if args.stats_port else None
    if srv is not None:
        print(f"stats: http://127.0.0.1:{srv.server_address[1]}/stats")

    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed))
    toks = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))
    batch = {"tokens": torch.from_numpy(toks).to(device)}
    t0 = time.time()
    toks = generate(cfg, params, batch, args.prompt_len, args.gen)
    dt = time.time() - t0
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(toks.cpu().numpy())
    if args.stats:
        print(json.dumps(stats(), indent=2, sort_keys=True))
    if srv is not None:
        srv.shutdown()
    return toks


if __name__ == "__main__":
    main()

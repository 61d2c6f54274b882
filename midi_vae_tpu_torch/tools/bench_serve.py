#!/usr/bin/env python
"""Serving benchmark on the card: style transfers through a serving bundle
(``serving.py``) and through the live ``GenerationContext``, at the
reference width (a seeded ``Config()``, GRU 256 x 2, latent 256, 64-step
windows; ``--set cell_type=LSTM`` for the LSTM model). Counterpart of
``tools/bench_serve.py``; a tool run by hand, whose numbers PERF.md keeps.

  * ``sustained``: K batches staged on the card, each transferred by one
    call (the bundle's ``style_transfer`` program, the live
    ``transfer_argmax``) with no host sync between them, one synchronize
    after the K: the rate the card sustains when the host runs ahead.
  * ``percall``: the public song API (``style_transfer_song``: numpy in,
    padding, upload, the transfer, the argmax fetched and post-processed),
    once per batch, from the host.

The bundle and the live context run in turns (bundle, live, live, bundle
per timing window), each figure the median of ``--reps`` windows. Prints
one JSON line per figure (``port_serve_{bundle|live}_{sustained|percall}``)
with the card's name and power limit, then the bundle's export seconds and
bytes.

    python -m midi_vae_tpu_torch.tools.bench_serve [--batch 256] [--song 16]
        [--batches 16] [--reps 7] [--set cell_type=LSTM]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=256, help="windows per transfer")
    ap.add_argument("--song", type=int, default=16, help="windows of the per-call song")
    ap.add_argument("--batches", type=int, default=16, help="K batches of a sustained window")
    ap.add_argument("--reps", type=int, default=7, help="timing windows per figure")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="Config override, as the train CLI's --set")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from midi_vae_tpu_torch import bridge
    from midi_vae_tpu_torch.config import Config, parse_overrides
    from midi_vae_tpu_torch.evaluation.generation import GenerationContext
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.serving import export_serving_bundle, load_serving_bundle

    if not torch.cuda.is_available():
        raise SystemExit("bench_serve measures the card: torch.cuda.is_available() is False")
    smi = _smi()
    cfg = Config(**parse_overrides(args.set))
    params = bridge.to_tree(MidiVAE(cfg).params)
    B, K = args.batch, args.batches
    with tempfile.TemporaryDirectory() as work:
        manifest = export_serving_bundle(cfg, params, work, sorted({args.song, B}), "cuda")
        bundle = load_serving_bundle(work)
        ctx = GenerationContext(cfg, MidiVAE(cfg, params), "cuda")

        rng = np.random.RandomState(1)
        eye = lambda d, idx: np.eye(d, dtype=np.float32)[idx]  # noqa: E731
        X = eye(cfg.input_dim, rng.randint(0, cfg.input_dim, (B, cfg.input_length)))
        I = eye(cfg.instrument_dim, rng.randint(0, cfg.instrument_dim, cfg.max_voices))
        V = rng.rand(B, cfg.output_length).astype(np.float32)
        D = rng.randint(0, 2, (B, cfg.output_length)).astype(np.float32)
        padded, _ = bundle.pad_batch(bundle._song_batch(X, I, V, D))
        staged = [{k: torch.as_tensor(v, device="cuda").clone() for k, v in padded.items()}
                  for _ in range(K)]
        perm = torch.arange(cfg.latent_dim, device="cuda")
        perm[[0, 1]] = perm[[1, 0]]
        A = torch.zeros(B, bundle.manifest["additional_dim"], device="cuda")

        def sustained(name):
            def run():
                for batch in staged:
                    if name == "bundle":
                        bundle.call("style_transfer", B, batch, perm, A)
                    else:
                        ctx.transfer_argmax(batch, perm, A)
                torch.cuda.synchronize()
            return run

        def percall(name):
            src = bundle if name == "bundle" else ctx
            n = args.song
            return lambda: src.style_transfer_song(X[:n], I, V[:n], D[:n], C=0, C_switch=1)

        figures = {("bundle", "sustained"): (sustained("bundle"), K * B),
                   ("live", "sustained"): (sustained("live"), K * B),
                   ("bundle", "percall"): (percall("bundle"), args.song),
                   ("live", "percall"): (percall("live"), args.song)}
        for fn, _ in figures.values():
            fn()  # warm: the kernels' first launches, the packing cache
        times = {key: [] for key in figures}
        for _ in range(args.reps):
            for mode in ("sustained", "percall"):
                for name in ("bundle", "live", "live", "bundle"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    figures[(name, mode)][0]()
                    times[(name, mode)].append(time.perf_counter() - t0)
        for (name, mode), (_, windows) in figures.items():
            t = sorted(times[(name, mode)])
            secs = t[len(t) // 2]
            calls = K if mode == "sustained" else 1
            print(json.dumps({
                "metric": f"port_serve_{name}_{mode}_transfer_note_steps_per_s",
                "value": windows * cfg.output_length / secs, "unit": "note-steps/s",
                "ms_per_call": secs / calls * 1e3, "windows_per_call": windows // calls,
                "calls_per_window": calls, "reps": args.reps, "cell_type": cfg.cell_type,
                "device": torch.cuda.get_device_name(0), "power": smi}))
        print(json.dumps({"metric": "port_serve_bundle_export", "export_seconds":
                          manifest["export_seconds"], "bytes": manifest["blob_bytes"],
                          "device": torch.cuda.get_device_name(0), "power": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

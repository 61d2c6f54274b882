#!/usr/bin/env python3
"""Smoke test of the PyTorch port (midi_vae_tpu_torch) on one CUDA card.

Run from the repo root:  python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero and prints no
result line):
  1. device: a CUDA card must be present; prints nvidia-smi's name and power
     limit line;
  2. build: nvcc builds kernel A (csrc/gru_layer_fwd.cu) and kernel B
     (csrc/gru_decode.cu) from the checkout;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the transfer path gives it with B = 256 windows, with times
     (CUDA events, median of REPS runs);
  4. slice: the transfer CLI (midi_vae_tpu_torch.cli.transfer.main) at the
     full default Config() width on 3 authored songs, with
     --write-reconstruction; the .mid files must parse back and the launch
     counters must show every kernel on the path was launched;
  5. card against CPU: one 256-window transfer_argmax batch on the card and
     through the plain path on the CPU; z, probs and argmax must agree. Prints
     windows/s and note-steps/s on the card.
Then one JSON line with the kernels, and the final line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# float32 with TF32 off on both sides; the kernels sum in another order than
# cuBLAS, and kernel B's errors compound over 64 fed-back steps
H_ATOL = 5e-5       # kernel A's h, kernel B's probs
LOGITS_ATOL = 1e-4  # kernel B's logits
# card vs CPU end to end (encoder dense layers + 64-step decode on top)
Z_ATOL = 1e-4
PROBS_ATOL = 1e-4
MIN_ARGMAX_AGREEMENT = 0.999
REPS = 20
B = 256
RAGGED = 5  # rows of a batch smaller than one block's tile


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} card(s)")
    print(smi)
    return smi


def phase_build():
    from midi_vae_tpu_torch.ops import _build

    t0 = time.perf_counter()
    for name in ("gru_layer_fwd", "gru_decode"):
        _build.load(name)
    secs = {k: round(v, 2) for k, v in _build.build_seconds.items()}
    print(f"[build] {time.perf_counter() - t0:.2f} s; nvcc per library: {secs}")


def random_batch(cfg, n, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    eye = lambda d, idx: np.eye(d, dtype=np.float32)[idx]  # noqa: E731
    return {
        "X": eye(cfg.input_dim, rng.randint(0, cfg.input_dim, (n, cfg.input_length))),
        "I": eye(cfg.instrument_dim, rng.randint(0, cfg.instrument_dim, (n, cfg.max_voices))),
        "V": rng.rand(n, cfg.output_length, 1).astype(np.float32),
        "D": eye(2, rng.randint(0, 2, (n, cfg.output_length))),
    }


def median_ms(fn):
    import torch

    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def check(name, kernel_fn, plain_fn, limits):
    """Kernel vs plain on the same inputs: max |diff| per output, within limits."""
    import torch

    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = []
    for g, w, limit in zip(got, want, limits):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"{name}: kernel output {tuple(g.shape)} not finite or not {tuple(w.shape)}")
        err = (g - w).abs().max().item()
        if not err <= limit:
            raise RuntimeError(f"{name}: max |kernel - plain| = {err:.3e} > {limit:.0e}")
        errs.append(err)
    return errs


def compare(name, kernel_fn, plain_fn, limits):
    """check(), then both timed in turns (plain, kernel, kernel, plain)."""
    errs = check(name, kernel_fn, plain_fn, limits)
    plain_a, kernel_a = median_ms(plain_fn), median_ms(kernel_fn)
    kernel_b, plain_b = median_ms(kernel_fn), median_ms(plain_fn)
    ms, plain_ms = (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2
    print(f"[kernels] {name}: max|diff| {', '.join(f'{e:.3e}' for e in errs)} "
          f"(limits {', '.join(f'{x:.0e}' for x in limits)}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}


def phase_kernels():
    """Both kernels at the path's shapes, with the default model's weights."""
    import torch

    from midi_vae_tpu.config import Config
    from midi_vae_tpu_torch.models.rnn import init_decoder_states
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.ops.gru_decode import gru_decode, gru_decode_reference
    from midi_vae_tpu_torch.ops.gru_layer import gru_layer, gru_layer_reference

    cfg = Config()
    dev = torch.device("cuda")
    model = MidiVAE(cfg).to(dev)
    enc, dec = model.params["encoder"], model.params["decoder"]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, B, 1).items()}
    tm = lambda a: a.transpose(0, 1).contiguous()  # noqa: E731  (B, T, D) -> (T, B, D)
    h0 = torch.zeros(B, cfg.lstm_size, device=dev)
    with torch.inference_mode():
        x_l2 = gru_layer_reference(tm(batch["X"]), h0, *(enc["notes_rnn"][0][k] for k in "wbu"),
                                   "tanh", True)
        layer_cases = [
            ("notes_l1", tm(batch["X"]), enc["notes_rnn"][0], True),
            ("notes_l2", x_l2, enc["notes_rnn"][1], False),
            ("instrument", tm(batch["I"]), enc["inst_rnn"][0], False),
            ("velocity", tm(batch["V"]), enc["vel_rnn"][0], False),
        ]
        results = {"gru_layer_fwd": {}, "gru_decode": {}}
        for name, x, p, rs in layer_cases:
            args = (x, h0, p["w"], p["b"], p["u"], "tanh", rs)
            results["gru_layer_fwd"][name] = compare(
                f"A {name} x{tuple(x.shape)} rs={rs}",
                lambda a=args: gru_layer(*a), lambda a=args: gru_layer_reference(*a), [H_ATOL])
            # a short song's bucket: fewer rows than a block's 8
            args = (x[:, :RAGGED].contiguous(), h0[:RAGGED], p["w"], p["b"], p["u"], "tanh", rs)
            check(f"A {name} B={RAGGED}", lambda a=args: gru_layer(*a),
                  lambda a=args: gru_layer_reference(*a), [H_ATOL])
        z = model.encode(batch)
        new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
        head_cases = [
            ("notes", cfg.output_dim, cfg.output_length, cfg.activation),
            ("velocity", 1, cfg.meta_velocity_length, cfg.meta_velocity_activation),
            ("instrument", cfg.meta_instrument_dim, cfg.meta_instrument_length,
             cfg.meta_instrument_activation),
        ]
        for name, d, T, out_act in head_cases:
            h = dec[name]
            states = [s[0] for s in init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                                        cfg.lstm_state_activation)]
            args = (list(h["cells"]), h["out"], states, torch.zeros(B, d, device=dev), T, "tanh",
                    out_act)
            results["gru_decode"][name] = compare(
                f"B {name} layers={len(h['cells'])} D={d} T={T} {out_act}",
                lambda a=args: gru_decode(*a), lambda a=args: gru_decode_reference(*a),
                [H_ATOL, LOGITS_ATOL])
            args = (args[0], args[1], [s[:RAGGED] for s in states],
                    torch.zeros(RAGGED, d, device=dev), T, "tanh", out_act)
            check(f"B {name} B={RAGGED}", lambda a=args: gru_decode(*a),
                  lambda a=args: gru_decode_reference(*a), [H_ATOL, LOGITS_ATOL])
        print(f"[kernels] every kernel call also agrees at B = {RAGGED}")
    return results


def phase_slice(work):
    """The transfer CLI at full width on 3 authored songs, on the card."""
    import numpy as np

    from midi_vae_tpu.config import Config
    from midi_vae_tpu.data import smf
    from midi_vae_tpu_torch import bridge
    from midi_vae_tpu_torch.cli import transfer
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.ops.gru_decode import gru_decode
    from midi_vae_tpu_torch.ops.gru_layer import gru_layer
    from midi_vae_tpu_torch.training.checkpoint import save_run

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_demo_corpus as corpus

    cfg = Config()
    run = os.path.join(work, "run")
    save_run(run, cfg, bridge.to_tree(MidiVAE(cfg).params))
    songs_dir = os.path.join(work, "songs", "style1")
    os.makedirs(songs_dir)
    rng = np.random.RandomState(0)
    inputs = []
    for i in range(3):
        path = os.path.join(songs_dir, f"song{i}.mid")
        corpus.make_song(corpus.STYLES["style1"], rng).write(path)
        inputs.append(path)
    out = os.path.join(work, "out")

    gru_layer.launches = gru_decode.launches = 0
    t0 = time.perf_counter()
    rc = transfer.main(["--model", run, "--input", *inputs, "--to-class", "style2",
                        "--output", out, "--device", "cuda", "--write-reconstruction"])
    secs = time.perf_counter() - t0
    launches = {"gru_layer_fwd": gru_layer.launches, "gru_decode": gru_decode.launches}
    if rc != 0:
        raise RuntimeError(f"transfer CLI returned {rc}")
    written = sorted(os.listdir(out))
    expected = sorted([f"song{i}_style1_to_style2.mid" for i in range(3)]
                      + [f"song{i}_reconstruction.mid" for i in range(3)])
    if written != expected:
        raise RuntimeError(f"transfer wrote {written}, expected {expected}")
    for name in written:
        mid = smf.read_midi(os.path.join(out, name))
        if not mid.instruments or not any(inst.notes for inst in mid.instruments):
            raise RuntimeError(f"{name} parsed back with no notes")
    # per song: transfer (encode 4 layers, decode 3 heads) + reconstruction
    # (encode_song 4 layers, decode_and_process 3 heads)
    want = {"gru_layer_fwd": 8 * len(inputs), "gru_decode": 6 * len(inputs)}
    if launches != want:
        raise RuntimeError(f"launch counters {launches}, expected {want}")
    print(f"[slice] transfer CLI on {len(inputs)} songs in {secs:.2f} s (build done); wrote "
          f"{len(written)} .mid files that parse back; launches {launches}")
    return launches


def phase_card_vs_cpu(smi):
    """One 256-window transfer_argmax batch: card against the CPU plain path."""
    import numpy as np
    import torch

    from midi_vae_tpu.config import Config
    from midi_vae_tpu_torch import bridge
    from midi_vae_tpu_torch.evaluation.generation import GenerationContext
    from midi_vae_tpu_torch.models.vae import MidiVAE

    cfg = Config()
    params = bridge.to_tree(MidiVAE(cfg).params)
    batch = random_batch(cfg, B, 2)
    results = {}
    for device in ("cuda", "cpu"):
        ctx = GenerationContext(cfg, MidiVAE(cfg, params), device)
        dev_batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        perm = torch.arange(cfg.latent_dim, device=device)
        perm[[0, 1]] = perm[[1, 0]]
        A = torch.zeros(B, 1, device=device)  # the default config has no additional input
        idx, switched = ctx.transfer_argmax(dev_batch, perm, A)
        H = torch.zeros_like(switched)
        H[1:] = switched[:-1]
        with torch.inference_mode():
            heads = ctx.model.decode(switched, H)
        results[device] = {
            "z": switched.cpu().numpy(),
            "probs": {k: v[0].cpu().numpy() for k, v in heads.items()},
            "notes_idx": idx["notes_idx"].cpu().numpy(),
        }
        if device == "cuda":
            ctx.transfer_argmax(dev_batch, perm, A)
            torch.cuda.synchronize()
            times = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                out = ctx.transfer_argmax(dev_batch, perm, A)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                del out
            times.sort()
            secs = times[len(times) // 2]
    gpu, cpu = results["cuda"], results["cpu"]
    z_err = float(np.abs(gpu["z"] - cpu["z"]).max())
    p_err = max(float(np.abs(gpu["probs"][k] - cpu["probs"][k]).max()) for k in cpu["probs"])
    agree = float(np.mean(gpu["notes_idx"] == cpu["notes_idx"]))
    for k, v in gpu["probs"].items():
        if not np.isfinite(v).all():
            raise RuntimeError(f"card probs of head {k} are not finite")
    if not (z_err <= Z_ATOL and p_err <= PROBS_ATOL and agree >= MIN_ARGMAX_AGREEMENT):
        raise RuntimeError(f"card vs CPU: max|dz| {z_err:.3e} (limit {Z_ATOL:.0e}), max|dprobs| "
                           f"{p_err:.3e} (limit {PROBS_ATOL:.0e}), notes argmax agreement {agree:.5f} "
                           f"(limit {MIN_ARGMAX_AGREEMENT})")
    steps = B * cfg.output_length
    print(f"[card vs cpu] {B} windows: max|dz| {z_err:.3e}, max|dprobs| {p_err:.3e}, notes argmax "
          f"agreement {agree:.5f}; transfer_argmax on the card {secs * 1e3:.3f} ms (median of {REPS}) = "
          f"{B / secs:.1f} windows/s = {steps / secs:.1f} note-steps/s on {smi}")


def main() -> int:
    smi = phase_device()
    import torch

    from midi_vae_tpu_torch import use_exact_f32

    use_exact_f32()
    phase_build()
    results = phase_kernels()
    with tempfile.TemporaryDirectory() as work:
        launches = phase_slice(work)
    phase_card_vs_cpu(smi)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")

    meta = {
        "gru_layer_fwd": ("midi_vae_tpu_torch/csrc/gru_layer_fwd.cu",
                          "midi_vae_tpu/ops/fused_train.py:2057",
                          ["midi_vae_tpu/ops/fused_train.py:2919"]),
        "gru_decode": ("midi_vae_tpu_torch/csrc/gru_decode.cu",
                       "midi_vae_tpu/ops/fused_decoder.py:61",
                       ["midi_vae_tpu/ops/fused_decoder.py:95"]),
    }
    kernels = []
    for name, (source, replaces, also) in meta.items():
        per_call = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "also_replaces": also, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in per_call.values()),
            # summed over the kernel's calls in one transfer of B windows
            "ms": sum(r["ms"] for r in per_call.values()),
            "plain_ms": sum(r["plain_ms"] for r in per_call.values()),
            "calls": per_call,
        })
    print(json.dumps({"kernels": kernels, "power": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

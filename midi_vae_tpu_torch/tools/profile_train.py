#!/usr/bin/env python3
"""Where the time of one training step goes, on a CUDA card.

Runs ``VAETrainer.train_step`` (forward, loss, backward, Adam) of the default
Config() model (seeded numpy init; ``--set`` overrides fields, e.g.
``lstm_size=512`` for the wide model, ``cell_type=LSTM`` for the LSTM model)
on one random 256-window batch, or with ``--judge KIND`` one
``ClassifierTrainer.train_step`` of that judge (RNN(256) x 2 of the config's
cell type) on one random batch (default 512), and prints one JSON line: the
card, the route of the step, the median wall time per step (host clock
around work that ends in a synchronize), note-steps/s (B x 64 output steps
per step; windows/s for a judge), and from a torch.profiler window of STEPS
steps the device time per kernel name, per kernel of the port (A, D, F,
G, the wide D, A's and L's pre-pass, A's chain, A's and L's per-block
routes, C's and E's phases (their shared gate pre-pass, C's chain and dx
pass, E's chain: every E build, wide or not, runs it), N's and R's phases,
the forward chain of Q and L, S, S xp, T, T xp, B's chain and per-block
route, X, Y, W; the bf16 builds of
A, D, G, the wide D, L, the phases, S, T and W apart, the bf16 chain of Q,
Y and L together) and for
everything else, per autograd node of the backward, and the device's idle
share.

Usage: python -m midi_vae_tpu_torch.tools.profile_train [--batch 256] [--steps 10]
           [--set lstm_size=512] [--set compute_dtype=bfloat16] [--set cell_type=LSTM]
           [--judge pitch]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# kernel name prefixes of the port's hand-written kernels
PORT_KERNELS = {
    # A: its x @ W pre-pass (xproj, L's: one config runs A or L), its
    # chain, its per-block route (no config at H <= 512 takes it)
    "xproj_kernel": "A/L xproj xproj",
    "gru_fwd_chain_kernel": "A chain gru_fwd_chain",
    "gru_fwd_chain_mma_kernel": "A chain bf16 gru_fwd_chain_mma",
    "gru_layer_fwd_kernel": "A block gru_layer_fwd",
    # B: its decode chain on clusters, its per-block route
    "gru_decode_chain_kernel": "B chain gru_decode_chain",
    "gru_decode_kernel": "B block gru_decode",
    # C's and E's phases: the gate pre-pass's two products (one kernel
    # name for both ops), C's chain and dx pass, E's chain through a head
    "gru_gates_p1_kernel": "C/E gates gru_gates_p1",
    "gru_gates_p2_kernel": "C/E gates gru_gates_p2",
    "gru_bwd_chain_kernel": "C chain gru_bwd_chain",
    "gru_bwd_dx_kernel": "C dx gru_bwd_dx",
    "gru_decode_train_kernel": "D gru_decode_train",
    "gru_head_bwd_chain_kernel": "E chain gru_head_bwd_chain",
    "gru_layer_xp_fwd_kernel": "F gru_layer_xp_fwd",
    "gru_layer_xp_bwd_kernel": "G gru_layer_xp_bwd",
    "gru_decode_train_wide_kernel": "D wide gru_decode_train_wide",
    # L: its x @ W pre-pass is A's (above); its chain is the forward chain
    # below; its per-block route (no config at H <= 512 takes it)
    "lstm_layer_fwd_kernel": "L block lstm_layer_fwd",
    # the forward chain of Q, Y and L: the float32 build (Q or L) and the
    # bf16 one (Q bf16, Y or L bf16: one config's encoder runs one of them)
    "lstm_fwd_chain_kernel": "Q/L chain lstm_fwd_chain",
    "lstm_fwd_chain_mma_kernel": "Q/Y/L bf16 chain lstm_fwd_chain_mma",
    # N's and R's phases (one config runs N or R, not both)
    "lstm_bwd_gates_kernel": "N/R gates lstm_bwd_gates",
    "lstm_bwd_gates_mma_kernel": "N/R gates bf16 lstm_bwd_gates_mma",
    "lstm_bwd_chain_kernel": "N/R chain lstm_bwd_chain",
    "lstm_bwd_dx_kernel": "N dx lstm_bwd_dx",
    "lstm_step_kernel": "S lstm_step",
    "lstm_step_xp_kernel": "S xp lstm_step_xp",
    # T's instances (T xp: those with kXp = true, counted apart below)
    "gru_step_tc_kernel": "T gru_step_tc",
    "gru_encoder_scan_kernel": "X gru_encoder_scan",
    "grad_reduce": "W grad_reduce",
}
# the groups whose kernels have a bf16 build, counted apart
BF16_BUILDS = ("A/L xproj xproj", "A chain gru_fwd_chain", "A block gru_layer_fwd",
               "C/E gates gru_gates_p1", "C/E gates gru_gates_p2", "C chain gru_bwd_chain",
               "C dx gru_bwd_dx", "D gru_decode_train", "E chain gru_head_bwd_chain",
               "G gru_layer_xp_bwd", "D wide gru_decode_train_wide", "L block lstm_layer_fwd",
               "N/R chain lstm_bwd_chain",
               "N dx lstm_bwd_dx", "S lstm_step", "T gru_step_tc",
               "W grad_reduce")


def random_train_batch(cfg, n: int, seed: int, valid: int | None = None) -> dict:
    """A numpy training batch of n random windows (X, Y, I, V, D, C, S and
    H when the config has history); rows from ``valid`` on are zeroed and
    masked out in ``M``, as an epoch's padded last batch."""
    rng = np.random.RandomState(seed)
    eye = lambda d, idx: np.eye(d, dtype=np.float32)[idx]  # noqa: E731
    batch = {
        "X": eye(cfg.input_dim, rng.randint(0, cfg.input_dim, (n, cfg.input_length))),
        "Y": eye(cfg.output_dim, rng.randint(0, cfg.output_dim, (n, cfg.output_length))),
        "I": eye(cfg.instrument_dim, rng.randint(0, cfg.instrument_dim, (n, cfg.max_voices))),
        "V": rng.rand(n, cfg.output_length, 1).astype(np.float32),
        "D": eye(2, rng.randint(0, 2, (n, cfg.output_length))),
        "C": eye(cfg.num_classes, rng.randint(0, cfg.num_classes, n)),
        "S": rng.randn(n, cfg.signature_vector_length).astype(np.float32),
    }
    if cfg.history:
        batch["H"] = (0.1 * rng.randn(n, cfg.latent_dim)).astype(np.float32)
    valid = n if valid is None else valid
    for v in batch.values():
        v[valid:] = 0
    batch["M"] = (np.arange(n) < valid).astype(np.float32)
    return batch


def _device_us(event, own: bool = True) -> float:
    """The device time of a profiler event: its own, or with ``own=False``
    that of every kernel launched under it."""
    for attr in (("self_device_time_total", "self_cuda_time_total") if own
                 else ("device_time_total", "cuda_time_total")):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


NODE = "autograd::engine::evaluate_function: "


def _profile(step, steps: int) -> dict:
    """Median wall time of ``step`` over ``steps`` runs and a torch.profiler
    window of as many: device ms per kernel name and per port kernel, and
    the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    walls.sort()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) / steps * 1e3
    kernels, nodes = {}, {}
    for ev in prof.key_averages():
        if ev.key.startswith(NODE):
            nodes[ev.key[len(NODE):]] = _device_us(ev, own=False) / steps / 1e3
            continue
        us = _device_us(ev)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key.split("(")[0]  # drop the argument list
            kernels[name] = kernels.get(name, 0.0) + us / steps / 1e3
    busy = sum(kernels.values())
    groups: dict[str, float] = {}
    for name, ms in kernels.items():
        short = name.split("<")[0].replace("void ", "").replace("mvt::", "")
        group = next((g for prefix, g in PORT_KERNELS.items() if short == prefix
                      or short.startswith(prefix + "_")),
                     "other (ATen, cuBLAS, copies)")
        if group == "T gru_step_tc" and ", true," in name:
            group = "T xp gru_step_tc"
        if group in BF16_BUILDS and "bfloat16" in name:
            letter, library = group.rsplit(" ", 1)
            group = f"{letter} bf16 {library}"
        groups[group] = groups.get(group, 0.0) + ms
    return {
        "step_wall_ms_median": walls[len(walls) // 2] * 1e3,
        "profiled_ms_per_step": window, "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / window,
        "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "device_ms_by_kernel": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12]),
        # the backward by autograd node, with the kernels each launched (e.g.
        # RematStepBackward: the per-step cells' backward through their plain
        # versions)
        "backward_device_ms_by_node": dict(sorted(nodes.items(), key=lambda kv: -kv[1])[:8]),
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=None,
                   help="batch rows (default 256, 512 with --judge)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any Config field")
    p.add_argument("--judge", default=None, choices=("pitch", "velocity", "instrument"),
                   help="profile one training step of this judge instead")
    args = p.parse_args(argv)

    import torch

    from midi_vae_tpu_torch.config import Config, parse_overrides
    from midi_vae_tpu_torch import use_exact_f32
    from midi_vae_tpu_torch.ops import _layout

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    use_exact_f32()
    if args.judge:
        from midi_vae_tpu_torch.models.classifier import ClassifierSpec, StyleClassifier
        from midi_vae_tpu_torch.training.classifier_trainer import ClassifierTrainer

        batch = args.batch or 512
        spec = ClassifierSpec.for_kind(args.judge, Config(**parse_overrides(args.set)),
                                       batch_size=batch)
        trainer = ClassifierTrainer(spec, "cuda")
        state = trainer.init_state()
        T = {"pitch": 64, "velocity": 64, "instrument": 4}[args.judge]
        rng = np.random.RandomState(0)
        x = (np.eye(spec.input_dim, dtype=np.float32)[rng.randint(0, spec.input_dim, (batch, T))]
             if spec.input_dim > 1 else rng.rand(batch, T, 1).astype(np.float32))
        c = np.eye(spec.num_classes, dtype=np.float32)[rng.randint(0, spec.num_classes, batch)]
        dev = [torch.as_tensor(a, device="cuda") for a in (x, c, np.ones(batch, np.float32))]
        out = _profile(lambda: trainer.train_step(state, *dev), args.steps)
        head = {"judge": args.judge, "cell_type": spec.cell_type, "batch": batch,
                "lstm_size": spec.lstm_size,
                "route": StyleClassifier(spec).train_route(torch.device("cuda")), "card": card}
        out["windows_per_s"] = batch / out["step_wall_ms_median"] * 1e3
    else:
        from midi_vae_tpu_torch.training.trainer import VAETrainer

        batch = args.batch or 256
        cfg = Config(batch_size=batch, **parse_overrides(args.set))
        trainer = VAETrainer(cfg, "cuda")
        state = trainer.init_state()
        tb = trainer.to_device(random_train_batch(cfg, batch, 0))
        out = _profile(lambda: trainer.train_step(state, tb), args.steps)
        head = {"batch": batch, "cell_type": cfg.cell_type, "lstm_size": cfg.lstm_size,
                "route": _layout.config_route(cfg), "card": card}
        out["note_steps_per_s"] = batch * cfg.output_length / out["step_wall_ms_median"] * 1e3
    print(json.dumps({**head, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

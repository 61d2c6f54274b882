"""Time kernels X and G, the GRU layer over a given xp = x @ W + b (X: the
bf16 forward, csrc/gru_encoder_scan.cu; G: the backward, float32 and bf16,
csrc/gru_layer_xp_bwd.cu), at the paths' shapes on the card.

Run from the repo root on a CUDA card:
    python -m midi_vae_tpu_torch.tools.time_x_and_g [--out FILE] [--only SECTION ...]
        [--H H ...] [--B B ...]

``--H`` and ``--B`` keep a section's cases at those widths and batches
(``--H 1024 --only xplans gplans``: GRU(1024)'s plans).

To compare two checkouts in one call, run the file from one with the
other's root on PYTHONPATH (``--only digests`` uses public wrappers that
older checkouts have too):
    PYTHONPATH=OLD python NEW/midi_vae_tpu_torch/tools/time_x_and_g.py --only digests

1. xplans: X's chain (A's bf16 chain over a bf16 xp) at every plan of
   ``_layout.gru_fwd_plans`` (each cluster size whose slice fits, each
   split count), and above H = 512 its streamed instance at every plan of
   ``_layout.gru_tc_plans(..., elem=2)``, on X_CASES (T 64; H 256: B 256,
   5 and 1024; H 512: B 256, 128 and 512; H 1024: B 256, 64, 16 and 5; the
   sequence emitted), beside the plan ``encoder_scan.scan_chain_plan``
   picks (``_timing.sweep``). Each plan's time is the device's: one launch
   in a CUDA-event window, the median of ``_timing.REPS``, the plans once
   in order and once reversed, the two medians averaged; its max |diff|
   from the pick. ``near_best`` lists the plans within ``_timing.NEAR`` of
   the fastest's time; tests/test_torch_gru_xp_chains.py and
   tests/test_torch_gru1024.py hold the picks against those sets.
2. gplans: G's chain (C's, with the bf16 build's dxp) at every cluster
   size ``_layout._bptt_candidate`` gives a plan at, on G_CASES (T 64;
   float32 at H 256, 512 and 1024, bf16 at H 256, 512 and 1024; B 256,
   128, 1024, 5), beside ``gru_layer.xp_bwd_plan``'s pick, timed as above
   (keys: the cluster size).
3. phases: at X_CASES and G_CASES up to H = 512, X and G through their public wrappers
   beside their per-block routes (the first designs, run at the same
   shapes), G's pre-pass and chain apart; each in one CUDA-event window,
   the median of ``_timing.REPS``, in turns (block, chain, chain, block).
4. digests: sha256 of kernel A's outputs (the pre-pass and the chain,
   float32 and bf16) and kernel C's (the pre-pass, the chain and the dx
   pass, float32 and bf16) on numpy-seeded inputs at (T 64, B 256, H 256
   and 512), and of kernel E's (each of its three chain instances: float,
   bf16 with the streams unrounded, bf16 rounded) on a numpy-seeded
   2-layer notes head: two checkouts whose A, C and E compute the same bits
   print the same digests.
Prints one JSON line per measurement, with the card's name and power limit.
"""

from __future__ import annotations

import hashlib
import sys

if __package__:
    from midi_vae_tpu_torch.tools import _timing
else:  # run as a file, perhaps beside another checkout's package
    import _timing

in_turns, max_diff, select, sweep = _timing.in_turns, _timing.max_diff, _timing.select, _timing.sweep
T = 64
# (H, B) of X: row 26 (GRU(256) at B 256 and 5), the bf16 GRU(256) at B
# 1024, wide512_bf16 (B 256), GRU(512) bf16 at B 128, row 27 (B 512);
# GRU(1024) bf16 at B 256, 64, 16 and 5 (its streamed instance; xplans
# only: the per-block route launches up to H = 512)
X_CASES = [(256, 256), (256, 5), (256, 1024), (512, 256), (512, 128), (512, 512),
           (1024, 256), (1024, 64), (1024, 16), (1024, 5)]
# (bf16, H, B) of G: rows 10 and 12 in float32 (GRU(256) and the wide
# step), row 10 in bf16 (wide512_bf16, GRU(512) at B 128, GRU(256) at B
# 1024), and B 5; GRU(1024)'s step in float32 and bf16 (gplans only)
G_CASES = [(False, 256, 256), (False, 512, 256), (False, 512, 5), (True, 512, 256),
           (True, 512, 128), (True, 256, 1024), (True, 512, 5), (False, 1024, 256),
           (True, 1024, 256)]


def _rand(gen, dev):
    import torch

    return (lambda *s: torch.rand(*s, generator=gen, device=dev),
            lambda *s: torch.randn(*s, generator=gen, device=dev))


def _x_operands(H, B, seed):
    import torch

    dev = torch.device("cuda")
    _u01, randn = _rand(torch.Generator(device=dev).manual_seed(seed), dev)
    bf = torch.bfloat16
    return (randn(T, B, 3 * H).to(bf), torch.tanh(randn(B, H)).to(bf),
            (randn(H, 3 * H) / H ** 0.5).to(bf))


def _g_operands(bf16, H, B, seed):
    """(xp, seq, h0, d_seq, u) of a G call: the sequence the plain forward's."""
    import torch

    from midi_vae_tpu_torch.ops import gru_layer as gl

    dev = torch.device("cuda")
    dt = torch.bfloat16 if bf16 else torch.float32
    _u01, randn = _rand(torch.Generator(device=dev).manual_seed(seed), dev)
    xp = randn(T, B, 3 * H).to(dt)
    h0 = torch.tanh(randn(B, H)).to(dt)
    u = (randn(H, 3 * H) / H ** 0.5).to(dt)
    with torch.no_grad():
        seq = gl.gru_layer_xp_reference(xp, h0, u)
    return xp, seq, h0, randn(T, B, H).to(dt), u


def time_xplans(emit, args):
    """X's chain at every plan: A's bf16 instance's where U's slice is
    resident, the streamed (tensor-core) instance's above H = 512."""
    import torch

    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import encoder_scan as es
    from midi_vae_tpu_torch.ops import gru_layer as gl

    key = lambda p: (f"tc {p.cluster}x{p.rows}/{p.chunk}/st{p.stages}" if p.chunk  # noqa: E731
                     else f"{p.cluster}x{p.rows}/s{p.splits}")
    for H, B in select(X_CASES, args):
        xp, h0, u = _x_operands(H, B, H + B)
        if _layout.gru_fwd_cluster(_layout.X_CHAIN_BUILD, H)[1]:
            what, plans = "X streamed plans", _layout.gru_tc_plans(H, B, es._tc_max_clusters,
                                                                   elem=2)
        else:
            what, plans = "X chain plans", _layout.gru_fwd_plans(
                _layout.X_CHAIN_BUILD, H, B, lambda C: gl._max_clusters("gru_encoder_scan", True, C))
        with torch.no_grad():
            sweep(emit, what, plans, _timing.patch("scan_chain_plan", es),
                  lambda: es.gru_encoder_scan_fwd(xp, h0, u, "tanh", True), key,
                  es.scan_chain_plan(H, B), H=H, B=B)


def time_gplans(emit, args):
    """G's chain at every cluster size its cost model gives a plan at."""
    import torch

    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import gru_layer as gl

    for bf16, H, B in select(G_CASES, args, H=lambda c: c[1], B=lambda c: c[2]):
        xp, seq, h0, d_seq, u = _g_operands(bf16, H, B, H + B)
        hprev = torch.cat([h0[None], seq[:-1]])
        with torch.no_grad():
            gates = gl.gru_bwd_gates_xp_reference(xp, hprev, u)[0]
        build = _layout.G_CHAIN_BUILDS[bf16]
        sweep(emit, f"{build} clusters at G's shapes", _timing.bptt_plans(build, H, B),
              _timing.patch("xp_bwd_plan", gl),
              lambda: gl.gru_layer_xp_bwd_chain(gates, hprev, d_seq, None, u),
              lambda p: p.cluster, gl.xp_bwd_plan(bf16, H, B), bf16=bf16, H=H, B=B)


def time_phases(emit, args):
    import torch

    from midi_vae_tpu_torch.ops import encoder_scan as es
    from midi_vae_tpu_torch.ops import gru_layer as gl

    for H, B in select([c for c in X_CASES if c[0] <= 512], args):
        xp, h0, u = _x_operands(H, B, 7 + H + B)
        chain = lambda: es.gru_encoder_scan_fwd(xp, h0, u, "tanh", True)  # noqa: E731
        block = lambda: es.gru_encoder_scan_block(xp, h0, u, "tanh", True)  # noqa: E731
        with torch.no_grad():
            diff = max_diff(chain(), es.gru_encoder_scan_reference(xp, h0, u, "tanh", True))
        ms = in_turns({"block": block, "chain": chain})
        emit({"what": "X", "H": H, "B": B, "T": T, "ms": ms["chain"], "ms_block": ms["block"],
              "max_abs_diff_from_plain": diff, "max_abs_diff_block": max_diff(block(), chain())})
    for bf16, H, B in select([c for c in G_CASES if c[1] <= 512], args, H=lambda c: c[1],
                             B=lambda c: c[2]):
        xp, seq, h0, d_seq, u = _g_operands(bf16, H, B, 11 + H + B)
        args = (xp, seq, h0, d_seq, None, u)
        hprev = torch.cat([h0[None], seq[:-1]])
        with torch.no_grad():
            gates = gl.gru_bwd_gates_xp_reference(xp, hprev, u)[0]
        fns = {"block": lambda: gl.gru_layer_xp_bwd_block(*args),
               "G": lambda: gl.gru_layer_xp_bwd(*args),
               "gates": lambda: gl.gru_layer_xp_bwd_gates(xp, hprev, u),
               "chain": lambda: gl.gru_layer_xp_bwd_chain(gates, hprev, d_seq, None, u)}
        with torch.no_grad():
            plain = gl.gru_layer_xp_bwd_reference(*args)
        diff = max_diff(fns["G"]()[1:3], plain[1:3])
        ms = in_turns(fns)
        emit({"what": "G", "bf16": bf16, "H": H, "B": B, "T": T, "ms": ms["G"],
              "ms_block": ms["block"], "ms_gates": ms["gates"], "ms_chain": ms["chain"],
              "max_abs_diff_dh0_dacat_from_plain": diff})


def _digest(ts):
    import torch

    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.detach().contiguous().view(-1).cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _e_head(H, dt, seed, B=256, D=61):
    """A 2-layer softmax decode head with E's inputs (the forward's probs
    and h sequences, the incoming grads) from numpy at ``seed``, in dt on
    the card."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    normal = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731

    def softmax(a):
        e = np.exp(a - a.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    card = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dt).cuda()  # noqa: E731
    cells = [{"w": card(normal(d, 3 * H, scale=d ** -0.5)),
              "u": card(normal(H, 3 * H, scale=H ** -0.5)), "b": card(normal(3 * H, scale=0.1))}
             for d in (D, H)]
    return {"cells": cells, "out": {"w": card(normal(H, D, scale=H ** -0.5)),
                                    "b": card(normal(D, scale=0.1))},
            "init": [card(np.tanh(normal(B, H))) for _ in range(2)],
            "start": card(softmax(normal(B, D))), "T": T, "out_activation": "softmax",
            "probs": card(softmax(normal(T, B, D))),
            "h_seqs": [card(np.tanh(normal(T, B, H))) for _ in range(2)],
            "g_probs": card(normal(T, B, D, scale=0.1)),
            "g_logits": card(normal(T, B, D, scale=0.1))}


def _e_outputs(outs):
    return [t for o in outs for k in ("dlogits", "da", "rh", "d_init", "d_start")
            for t in (o[k] if isinstance(o[k], list) else [o[k]])]


def digests():
    """{name: sha256 prefix} of A's, C's and E's outputs on numpy-seeded
    inputs."""
    import numpy as np
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops import gru_layer as gl

    out = {}
    for H in (256, 512):
        for dt in (torch.float32, torch.bfloat16):
            rng = np.random.RandomState(H)
            B, D = 256, 61
            arr = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
                (scale * rng.standard_normal(s)).astype(np.float32)).to(dt).cuda()
            x, h0 = arr(T, B, D), torch.tanh(arr(B, H))
            w, b, u = arr(D, 3 * H, scale=D ** -0.5), arr(3 * H, scale=0.1), arr(H, 3 * H, scale=H ** -0.5)
            seq, g = torch.tanh(arr(T, B, H)), arr(T, B, H)
            tag = f"H{H} {'bf16' if dt == torch.bfloat16 else 'f32'}"
            xp = gl.gru_layer_xproj(x, w, b)
            out[f"A xproj {tag}"] = _digest([xp])
            out[f"A chain seq {tag}"] = _digest([gl.gru_layer_fwd_chain(xp, h0, u, "tanh", True)])
            out[f"A chain last {tag}"] = _digest([gl.gru_layer_fwd_chain(xp, h0, u, "tanh", False)])
            out[f"C {tag}"] = _digest(gl.gru_layer_bwd(x, seq, h0, g, None, w, b, u, True))
            out[f"C last {tag}"] = _digest(gl.gru_layer_bwd(x, seq, h0, None, g[0], w, b, u,
                                                            False))
    # E's chain instances: float and bf16 (streams unrounded) at H 256, bf16
    # with the streams rounded (E wide bf16) and float (E wide) at H 512
    for name, H, dt, run in (
            ("E H256 f32", 256, torch.float32, lambda hs: gd.gru_decode_bwd(hs)),
            ("E H256 bf16", 256, torch.bfloat16, lambda hs: gd.gru_decode_bwd(hs)),
            ("E wide H512 f32", 512, torch.float32, lambda hs: gd.gru_decode_bwd_wide(hs)),
            ("E wide H512 bf16", 512, torch.bfloat16, lambda hs: gd.gru_decode_bwd_wide(hs))):
        out[name] = _digest(_e_outputs(run([_e_head(H, dt, H + 1)])))
    torch.cuda.synchronize()
    return out


SECTIONS = {"xplans": time_xplans, "gplans": time_gplans, "phases": time_phases,
            "digests": lambda emit, _args: emit({"what": "digests of A, C and E",
                                                 "digests": digests()})}


def main(argv=None) -> int:
    return _timing.main(__doc__, SECTIONS, argv)


if __name__ == "__main__":
    sys.exit(main())

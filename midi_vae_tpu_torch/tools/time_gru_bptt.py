"""Time the GRU backward chains of kernels C and E (csrc/gru_cell_bwd_chain.cuh)
at every cluster size their plan could take, at the paths' shapes.

Run from the repo root on a CUDA card:
    python -m midi_vae_tpu_torch.tools.time_gru_bptt [--out FILE] [--H H ...] [--B B ...]

For each case of CASES (the plan cases of tests/test_torch_gru_bwd_chain.py:
C's encoder layers and E's head groups, float32 and bf16, H 256 and 512, B
256, 512, 128 and 5; and GRU(1024)'s heads alone through E wide, float32,
and the instrument head through E wide bf16, B 256), at the widths
``--H`` and batches ``--B`` where given, and each cluster size C that
``_layout._bptt_candidate`` gives a plan at (the rows and clusters of each
part as ``gru_bptt_plan`` would set them at that size, at the card's active
clusters: ``_timing.bptt_plans``), the chain's wrapper runs with that plan
forced (``_timing.sweep``). Each size's time is the device's: one launch in
a CUDA-event window, the median of REPS, the sizes once in order and once
reversed, the two medians averaged; its max |diff| from the plan
``gru_bptt_plan`` picks. ``near_best`` lists the sizes within
``_timing.NEAR`` of the fastest's time; tests/test_torch_gru_bwd_chain.py
and tests/test_torch_gru1024.py hold ``gru_bptt_plan``'s picks against
those sets. Seeded random inputs
(the gates from C's pre-pass over random x and h). Prints one JSON line per
case, with the card's name and power limit.
"""

from __future__ import annotations

import sys

if __package__:
    from midi_vae_tpu_torch.tools import _timing
else:  # run as a file
    import _timing

# (chain build, H, B, heads): heads (D, n_layers, T, out activation) for E,
# None for C (one layer, T 64)
CASES = [("C_chain", 256, 256, None), ("C_chain", 256, 512, None),
         ("C_chain", 512, 256, None), ("C_chain", 256, 5, None),
         ("C_chain_bf16", 256, 256, None), ("C_chain_bf16", 512, 128, None),
         ("E_chain", 256, 256, ((61, 2, 64, "softmax"), (1, 1, 64, "sigmoid"))),
         ("E_chain", 256, 256, ((61, 2, 64, "softmax"), (1, 1, 64, "sigmoid"),
                                (2, 1, 64, "sigmoid"))),
         ("E_chain", 256, 256, ((16, 1, 4, "softmax"),)),
         ("E_chain", 512, 256, ((61, 2, 64, "softmax"),)),
         ("E_chain", 512, 256, ((1, 1, 64, "sigmoid"),)),
         ("E_chain", 256, 5, ((61, 2, 64, "softmax"),)),
         ("E_chain_bf16", 256, 256, ((61, 2, 64, "softmax"),)),
         ("E_chain_bf16", 512, 256, ((61, 2, 64, "softmax"),)),
         ("E_chain_bf16", 512, 256, ((16, 1, 4, "softmax"),)),
         ("E_chain_bf16", 512, 128, ((16, 1, 4, "softmax"),)),
         ("E_chain", 1024, 256, ((61, 2, 64, "softmax"),)),
         ("E_chain", 1024, 256, ((1, 1, 64, "sigmoid"),)),
         ("E_chain", 1024, 256, ((16, 1, 4, "softmax"),)),
         ("E_chain_bf16", 1024, 256, ((16, 1, 4, "softmax"),))]
REPS = 9
T_C = 64


def _c_call(H, B, dtype, gen):
    """C's chain over random gates: a function of the forced plan's run."""
    import torch

    from midi_vae_tpu_torch.ops import gru_layer as gl

    dev = torch.device("cuda")
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    gates = torch.cat([rand(T_C, B, 2 * H), 2 * rand(T_C, B, H) - 1], -1)
    hprev = torch.tanh(randn(T_C, B, H)).to(dtype)
    d_seq = randn(T_C, B, H).to(dtype)
    u = (randn(H, 3 * H) / H ** 0.5).to(dtype)
    return lambda: gl.gru_layer_bwd_chain(gates, hprev, d_seq, None, u)


def _e_call(H, B, dtype, heads, gen):
    """E's chain over a call's heads (their plain forward, the pre-pass's
    gates): a function of the forced plan's run."""
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd

    dev = torch.device("cuda")
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    dicts = []
    for D, n, T, act in heads:
        cells = [{"w": (randn(D if i == 0 else H, 3 * H) / (D if i == 0 else H) ** 0.5).to(dtype),
                  "u": (randn(H, 3 * H) / H ** 0.5).to(dtype), "b": (0.1 * randn(3 * H)).to(dtype)}
                 for i in range(n)]
        out = {"w": (randn(H, D) / H ** 0.5).to(dtype), "b": (0.1 * randn(D)).to(dtype)}
        init = [torch.tanh(randn(B, H)).to(dtype) for _ in range(n)]
        start = torch.softmax(randn(B, D), -1).to(dtype)
        with torch.no_grad():
            probs, _lg, h_seqs = gd.gru_decode_train_reference(cells, out, init, start, T, act)
        dicts.append({"cells": cells, "out": out, "init": init, "start": start, "T": T,
                      "out_activation": act, "probs": probs, "h_seqs": h_seqs,
                      "g_probs": randn(T, B, D).to(dtype), "g_logits": randn(T, B, D).to(dtype)})
    inputs = [gd._layer_inputs(h) for h in dicts]
    gates = gd.gru_decode_bwd_gates(dicts, inputs)
    hprevs = [[hp for _x, hp in ins] for ins in inputs]
    build = ("E_wide" if H >= 512 else "E") + ("_bf16" if dtype == torch.bfloat16 else "")
    return lambda: gd.gru_decode_bwd_chain(dicts, gates, build, hprevs)


def time_clusters(emit, args):
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops import gru_layer as gl

    for build, H, B, heads in _timing.select(CASES, args, H=lambda c: c[1], B=lambda c: c[2]):
        dtype = torch.bfloat16 if build.endswith("_bf16") else torch.float32
        gen = torch.Generator(device="cuda").manual_seed(H + B)
        shape = None if heads is None else tuple((d, n, T) for d, n, T, _a in heads)
        call = _c_call(H, B, dtype, gen) if heads is None else _e_call(H, B, dtype, heads, gen)
        with torch.no_grad():
            _timing.sweep(emit, f"{build} clusters", _timing.bptt_plans(build, H, B, shape),
                          _timing.patch("gru_bptt_plan", gl, gd), call, lambda p: p.cluster,
                          gl.gru_bptt_plan(build, H, B, shape), REPS, H=H, B=B, heads=shape)


def main(argv=None) -> int:
    return _timing.main(__doc__, {"clusters": time_clusters}, argv)


if __name__ == "__main__":
    sys.exit(main())

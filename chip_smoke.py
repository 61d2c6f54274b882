#!/usr/bin/env python3
"""Smoke test of the PyTorch port (midi_vae_tpu_torch) on one CUDA card.

Run from the repo root:  python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero and prints no
result line):
  1. device: a CUDA card must be present; prints nvidia-smi's name and power
     limit line;
  2. build: nvcc builds every kernel library from the checkout, one process
     per source, all started together: A (csrc/gru_layer_fwd.cu), B
     (csrc/gru_decode.cu), C (csrc/gru_layer_bwd.cu), D
     (csrc/gru_decode_train.cu), E (csrc/gru_decode_bwd.cu), W
     (csrc/grad_reduce.cu), F (csrc/gru_layer_xp_fwd.cu), G
     (csrc/gru_layer_xp_bwd.cu), L (csrc/lstm_layer_fwd.cu), M
     (csrc/lstm_decode.cu), N (csrc/lstm_layer_bwd.cu), Q
     (csrc/lstm_layer_xp_fwd.cu), R (csrc/lstm_layer_xp_bwd.cu), S and S xp
     (csrc/lstm_step.cu), T and T xp (csrc/gru_step.cu), with the bf16
     builds of A, C, D, E, G, the wide D and E, L, N, Q, R, S, T and W, X
     (csrc/gru_encoder_scan.cu), Y
     (csrc/lstm_encoder_scan.cu), U (csrc/gru_encoder_stack_fwd.cu) and V
     (csrc/gru_encoder_stack_bwd.cu), D's and E's bf16-residual builds and
     E wide's bf16 build with row 8's rounding; N and R as three phases
     each (csrc/lstm_cell_bwd.cuh: the gate pre-pass, the chain on
     thread-block clusters, N's dx pass); C and E as phases
     (csrc/gru_cell_bwd_chain.cuh: the gate pre-pass, the chain on
     clusters, C's dx pass), their plans at B = 256 with the card's active
     clusters; A as two phases (the x @ W
     pre-pass of csrc/xproj.cuh, L's, and the GRU chain on clusters of
     csrc/gru_cell_fwd.cuh) beside its per-block route; S and S xp as one
     product on the tensor cores (csrc/gemm_tc.cuh) with the cell in its
     epilogue; T, T bf16 and T xp as one launch on clusters, both products
     on the tensor cores; B as a decode chain on clusters
     (csrc/gru_decode_chain.cuh) beside its per-block route; X as A's bf16
     chain over a bf16 xp and G as an xp gate pre-pass and C's chain, each
     beside its per-block route; every build's
     registers and
     spills from ptxas against the route chooser's table (the phase builds
     also against their threads a block); the 8-rows builds of D and E must
     refuse H = 512 at their C entry points; each chain build's cluster
     size, whether it streams U^T, the card's
     cudaOccupancyMaxActiveClusters and its plan at B = 256 (A's chain
     builds too, and B's chain on the notes head); the instances of W (the
     tiles on the tensor cores, the small-I stream), of L and A (the x @ W
     pre-pass, the chain), of S, of T, of B's chain, of F's chain (A's
     instances and the tensor-core one), of the wide D's chain (B's
     training instance and the tensor-core one, its 256-thread CTAs at up
     to 255 registers) and of X's and G's chains and G's pre-pass must not
     spill; W's one-TF32-product control is built too (csrc/grad_reduce.cu
     with -DMVT_W_TF32_ONE);
  2a. A's, B's, C's, E's and the wide D's outputs on numpy-seeded inputs
     (the wide D's: tools/time_d_and_m.py --only digests) bit-equal to the
     parent commit's (PARENT_DIGESTS): X and G share A's and C's device
     code, F A's and the wide D's chain B's;
  2b. W: kernel W on the paths' reductions (W_CASES) against a float64 sum
     within W_REL_L2, two runs bit-equal, and the one-TF32-product control
     over W_REL_L2 on the tiled cases;
  3. kernels: A and B against their plain PyTorch versions on the card, at
     the shapes the transfer path gives them with B = 256 windows, with times
     (CUDA events, median of REPS runs) and each call's bound (the larger of
     its operations over the card's f32 rate and its bytes over HBM's); A's
     phases (the pre-pass beside torch.addmm, the chain, the per-block
     route) each against its plain version, and A and its phases at B = 5
     and one song's 16; B (its decode chain) at B = 16 and 5 too, and D's
     probs and logits bit-equal to B's on the three heads: D's chain to B's
     chain at D's plan (B's training instance), D's per-block route to B's
     per-block route (csrc/gru_decode_body.cuh);
  4. slice: the transfer CLI (midi_vae_tpu_torch.cli.transfer.main) at the
     full default Config() width on 3 authored songs, with
     --write-reconstruction; the .mid files must parse back and the launch
     counters must show every kernel on the path was launched;
  5. card against CPU: one 256-window transfer_argmax batch on the card and
     through the plain path on the CPU; z, probs and argmax must agree. Prints
     windows/s and note-steps/s on the card, and one song's latency;
  6. training kernels: C, D (its chain, one launch a head, and its
     per-block route on the same calls), E and W against their plain
     versions at the training step's shapes (B = 256) and at B = 5, with
     times (D's bounds by operand type: d_work; W beside
     cuBLAS's a.t() @ b), C's and E's phases each against its plain version
     on the same inputs (also in phases 9, 30, 33 and 39), and the
     gradients of the training ops against autograd through the plain
     forward;
  7. training slice: the train CLI (midi_vae_tpu_torch.cli.train.main) at
     the full default Config() width (batch 256) on an authored corpus for 2
     epochs, then --resume for a third, then the transfer CLI serves the
     run; losses finite, checkpoints on disk, and the launch counters of
     every kernel equal to what the design implies per step, eval batch and
     encode batch (the z cache gives the history: no encode pass over the
     train split but the one that seeds the cache on --resume);
  8. training step, card against CPU: one optimizer step's loss, metrics and
     every parameter gradient on a fixed 256-window batch with padding rows
     and numpy noise, on the card and through the plain path on the CPU;
     prints the card's step time and note-steps/s;
  9. wide kernels: the wide model (Config() with lstm_size=512) takes the
     wide route (ops/_layout.py): F and G over the four encoder layers'
     x-projections, the wide builds of D (on B's decode chain) and E on each
     decode head alone, and W over their gate grads, against their plain
     versions at B = 256 and B = 5, with times and bounds (F's and the wide
     D's priced by operand type: f_work, d_work), and the training ops'
     gradients against autograd; F's chain (its tensor-core instance at H
     = 512) and the wide D's chain each beside its per-block route on the
     same calls; G's phases (the xp gate pre-pass, the chain) each against
     its plain version, G's per-block route beside them on notes L1, and at
     H = 96, where it is G's route; F and G also at a GRU(256) layer (F: A's
     resident chain); A and B at H = 512 (the serving path of a wide run);
 10. wide training slice: the train CLI at --set lstm_size=512 for 2 epochs,
     --resume for a third, then the transfer CLI serves the run, with every
     launch counter equal to the wide design;
 11. wide training step, card against CPU, as phase 8 at lstm_size=512;
 12. teacher forcing: one teacher-forced step of the default config, card
     against CPU (the notes head's plain scan, D and E for the other heads);
 13. LSTM kernels: L and M (its decode chain on clusters,
     csrc/lstm_decode_chain.cuh, with both counts of h tiles a layer, and
     its per-block route) against their plain versions at the shapes of
     Config(cell_type="LSTM")'s transfer (LSTM(256) x 2), at B = 256 with
     times, bounds and, for L, cuDNN's LSTM timed beside it, and at B = 5;
     L's phases (the pre-pass beside torch.addmm, the chain beside cuDNN's
     forward over xp) each against its plain version, and L's per-block
     route (no path at these widths takes it) on the same layers; phase 17
     holds the phases on the training layers (with c), phase 36 in bf16,
     there beside the plain chain over xp rounded to bf16, a control that
     must land over BF16_STEP_REL_L2;
 14. LSTM slice with the judges: the transfer CLI serves an LSTM run with
     --write-reconstruction --classifiers (LSTM judges of all three kinds):
     per song L 4 and M 3 (8 and 6 with the reconstruction) plus L 2 per
     judge call; then the GRU slice once more with GRU judges (kernel A
     under --classifiers);
 15. LSTM card against CPU, as phase 5 for Config(cell_type="LSTM");
 16. the judges card against CPU: probs of each kind, LSTM and GRU;
 17. LSTM training kernels: L with its c sequence, N (csrc/lstm_layer_bwd.cu),
     S (csrc/lstm_step.cu) and W at the LSTM(256) step's shapes, Q
     (csrc/lstm_layer_xp_fwd.cu), R (csrc/lstm_layer_xp_bwd.cu) and W at
     LSTM(512)'s, against their plain versions at B = 256 (timed, with
     bounds and cuDNN's LSTM as the yardstick: its forward beside L, its
     backward beside N and R) and B = 5, each of N's and R's phases against
     its plain version on the same inputs, the gradients of
     lstm_layer_train_x, lstm_layer_train and lstm_cell_step against
     autograd through the plain forward, and one LSTM(512) notes layer's
     forward + backward timed on both routes;
 18. LSTM training slice: the train CLI with --set cell_type=LSTM (and with
     lstm_size=512, the wide route) for 2 epochs, --resume for a third, the
     transfer CLI serves the run, every launch counter as designed;
 19. LSTM training step, card against CPU, as phase 8 at LSTM(256) and
     LSTM(512);
 20. judge training: the classify CLI trains GRU judges (RNN(256) x 2,
     batch 512, 2 epochs; A + C + W), ClassifierTrainer LSTM judges of all
     three kinds (L + N + W), one judge step per cell type card against
     CPU, and the transfer CLI serves the trained LSTM judges;
 21. per-step cells: T (csrc/gru_step.cu) on each decode-head cell of
     Config() (notes 1 and 2, velocity, instrument) and of lstm_size=512, T
     xp on each encoder layer's x-projection at 256 and 512, S xp
     (csrc/lstm_step.cu) on each LSTM(256) and LSTM(512) encoder layer's,
     against their plain versions at B = 256 and B = 5 (T, T bf16 and T xp
     also at H = 192, 320, 384 and 448, B = 256, 16 and 5, where T's
     clusters are 3, 5, 6 and 7 CTAs); each cell's loop
     (its head's or layer's launches, the state carried) timed in one
     CUDA-event window beside the plain version's loop and, for S xp,
     torch.lstm_cell's, with bounds; then S (float32 and bf16) and S xp
     against their plain versions at every shape the paths give them (H 256
     and 512; B = 256, 16, 5; D = 61, H, 1, 16; the three cell activations);
 22. their gradients: the three autograd Functions against autograd through
     the plain forward;
 23. the train CLI on the per-step configs at full width, 2 epochs, --resume
     for a third, serving: --set merge_decoder_scans=True (T on the merged
     heads, D and E on the instrument head), --set fused_train_encoder=False
     --set fused_train_decoder=False (T xp and T), --set cell_type=LSTM
     --set fused_train_encoder=False (S xp and S), every launch counter as
     designed;
 24. one training step of each of those configs, card against CPU, as
     phase 8;
 25. serving a GRU run with a 3-layer notes head (--set
     num_layers_decoder=3, seeded init) through the transfer CLI: T 3 x 64
     launches per notes-head call; one transfer batch card against CPU;
 26. bf16 kernels: X (csrc/gru_encoder_scan.cu) on each encoder layer's
     x-projection of the bf16 GRU(256) step and at (T 64, B 512, H 512),
     the batch-tiled row 27; Y (csrc/lstm_encoder_scan.cu) on each of the
     bf16 LSTM(256) and LSTM(512) steps' (row 33 at 512); the bf16 builds of
     T and S on each head cell of GRU(256) and LSTM(256); each against its
     plain bf16 version at B = 256 (timed; the cells' loops in one window,
     with bounds at the bf16 tensor-core rate, cuDNN's LSTM in bf16 with
     w_ih = I beside Y and torch.lstm_cell in bf16 beside S) and at B = 5
     (T bf16 to BF16_STEP, beside a control that must land over it: its
     plain phases with r * h rounded to bf16), and the remat backward of X
     and Y against autograd through the plain forward; X's per-block route
     beside its chain on notes L1, X with every cell activation at H = 256
     and 512, and at H = 160, where the per-block design is its route;
 27. the train CLI on the two bf16 configs at full width, 2 epochs, --resume
     for a third, serving: --set compute_dtype=bfloat16 with both
     fused_train_* False (X 4 and T bf16 196 a step), and with cell_type=LSTM
     and fused_train_encoder=False (Y 4 and S bf16 196), every launch
     counter as designed;
 28. one training step of each, and of the bf16 LSTM(512) config, card
     against CPU (bf16 limits);
 29. the fused encoder stacks (ops/encoder_stack.py), which no main path
     runs: U (csrc/gru_encoder_stack_fwd.cu) and V
     (csrc/gru_encoder_stack_bwd.cu) at the default Config() encoder's
     shapes and seeded weights, the multi-branch op (notes stack, velocity
     and instrument branches) and stack2 (numpy-random h01 and h02, both
     return_sequences), against their plain versions at B = 256 (timed, with
     bounds) and B = 5; stack2 in bf16 with two controls that feed layer 2
     the rounded h1 and must land over BF16's relative L2, and at H = 512;
     both ops' gradients against autograd through the plain forward; the
     same encoder's forward and forward + backward through the per-layer
     route (A x 4, C x 4, W x 12) timed beside U and U + V + W; no main path
     launched U or V;
 30. bf16 with the default fused flags: the bf16 builds of A
     (csrc/gru_layer_fwd.cu), C (csrc/gru_layer_bwd.cu), W
     (csrc/grad_reduce.cu), D (csrc/gru_decode_train.cu) and E
     (csrc/gru_decode_bwd.cu) at the bf16 Config() step's shapes (the four
     encoder layers; the notes and instrument heads, each decoded alone; W
     over each layer's and head's products), against their plain bf16
     versions at B = 256 (timed, bf16 x bf16 products at the bf16 rate and
     the rest at the float32 rate, W beside cuBLAS on the widened operands)
     and B = 5, A's phases each against its plain version, D bf16's
     per-block route beside its chain; A and D also one
     step from a random state, where three wrong
     roundings (r * h in A, the gate grads before W, layer 2 fed the rounded
     h1 in D) must land over the limits; the autograd ops' gradients against
     the plain backward;
 31. the train CLI with --set compute_dtype=bfloat16 at full width, 2
     epochs, --resume for a third, serving: A and C in bf16 4 each a step,
     D and E in bf16 2 and in float32 1 (the velocity head), W 16 in bf16
     and 11 in float32, every launch counter as designed;
 32. one training step of that config and of merge_bf16, card against CPU
     (bf16 limits), with each step's time;
 33. bf16 on the wide route (Config(lstm_size=512, compute_dtype=bfloat16),
     the soak's wide512_bf16): per encoder layer kernel X
     (csrc/gru_encoder_scan.cu) as row 9 in bf16, G's bf16 build
     (csrc/gru_layer_xp_bwd.cu) and W for dU from G's float32 gate grads;
     on the notes and instrument heads the bf16 builds of the wide D
     (csrc/gru_decode_train.cu: B's decode chain in its bf16 training
     instance, beside its per-block route) and E (csrc/gru_decode_bwd.cu),
     whose dlogits and gate grads leave rounded to bf16, and W over them; each
     against its plain bf16 version at B = 256 (timed, with bounds, W beside
     cuBLAS) and B = 5, G bf16's phases each against its plain version (and
     its per-block route beside them on notes L1), X and G bf16 at B = 128,
     the autograd ops' gradients against the plain backward, and three
     controls: dU from the rounded dxp, the heads' weight grads from the
     unrounded streams, one D step with layer 2 fed the rounded h1;
 34. the train CLI with --set lstm_size=512 --set compute_dtype=bfloat16, 2
     epochs, --resume for a third, serving: X 4, G bf16 4, the wide D and E
     in bf16 2 and in float32 1 (velocity), W 12 in bf16 and 11 in float32
     a step, every launch counter as designed;
 35. that step card against CPU (bf16 limits), and one step on the card of
     it with fused_train_encoder=False (X and the wide heads) and with
     fused_train_decoder=False (X, G and T bf16): exact launch counts, a
     finite loss, each step's time;
 36. the bf16 LSTM with the default fused flags: at
     Config(cell_type="LSTM", compute_dtype=bfloat16)'s shapes (rows 19 and
     20 at B = 256) the bf16 builds of L (csrc/lstm_layer_fwd.cu) with the c
     sequence, N (csrc/lstm_layer_bwd.cu) and W over N's float32 gate
     grads; at LSTM(512)'s (rows 17 and 18) Q (csrc/lstm_layer_xp_fwd.cu)
     and R (csrc/lstm_layer_xp_bwd.cu) in bf16 over xp = x @ W + b in bf16
     and W for dU from R's rounded dxp; each against its plain bf16 version
     at B = 256 (timed, with bounds, cuDNN's bf16 LSTM forward and backward
     beside L, N, Q and R, W beside cuBLAS) and B = 5, L and Q also on two
     steps from a random state, N's and R's float32 gate grads at
     STREAM_REL_L2, the autograd ops' gradients against the plain backward
     and their dU against the plain sum of their row's gate grads, and four
     controls that must land over the limits those are held to: the layer
     with every op in bf16, c carried in float32, N's dU from the rounded
     da, R's dU from the other row's gate grads (wide and in place); each of
     N's and R's phases against its plain version, and on notes L2 their
     chain over the last two steps (step T-2's float32 gate grads within
     BF16_STEP_REL_L2) beside a fifth control that must land over it: the
     chain with da rounded to bf16 before the dh product;
 37. the train CLI with --set cell_type=LSTM --set compute_dtype=bfloat16, 2
     epochs, --resume for a third, serving: L and N in bf16 4 each, S bf16
     196, W bf16 8 a step, every launch counter as designed;
 38. that step and the bf16 LSTM(512)'s (Q and R in bf16 4 each, S bf16
     196, W bf16 4) card against CPU (bf16 limits), and one card step of
     each with fused_train_decoder=False: exact launch counts, a finite
     loss, each step's time;
 39. the last kernel instances a config reaches at H <= 512: at
     Config(meta_held_notes=True)'s shapes (B = 256 and B = 5) the notes +
     velocity and notes + velocity + held multi-head calls through D's
     bf16-residual build (decode_residual_bf16: probs and logits equal to
     the float32 build's bit for bit, the stored h sequences equal to its
     rounded to bf16; its per-block route on the same calls) and E's, and
     W over the rounded sequences, against their plain versions at the
     training kernels' limits (E fed the float32 sequences must land over
     them); the same call at H = 448, B = 32, off the narrow route, where
     D resid's chain and E resid's launch (``_multihead`` on the card); at
     Config(lstm_size=512, compute_dtype=bfloat16, batch_size=128)'s
     instrument head (B = 128 and 5), rows 7 and 8 through D's wide bf16
     build and E's wide bf16 build with row 8's rounding (its streams
     unrounded, within STREAM_REL_L2 of the plain version's; row 14's
     rounded build must land over it) and W; the autograd ops' gradients
     against the plain backward; times, bounds;
 40. the train CLI with --set decode_residual_bf16=True and with --set
     lstm_size=512 --set compute_dtype=bfloat16 --set batch_size=128, 2
     epochs, --resume for a third, serving, every launch counter as
     designed;
 41. one training step card against CPU of residual_bf16,
     held_residual_bf16 and held_notes (float32 limits), held_bf16 and the
     bf16 GRU(512) at B = 128 (bf16 limits), each step's time beside
     Config()'s.
 42. generation (after the GRU(1024) phases): cli.generate --device cuda on
     a seeded-init Config() run with an authored two-class corpus as
     --source, each mode (random, style, interpolate, long) with the
     default choice sampling and random with --sample-method argmax, then
     an LSTM run in random mode; every .mid parses back, the launch
     counters equal A 4 (L 4) per encode and B 3 (M 3) per decode call;
 43. evaluation: cli.evaluate --device cuda at Config() width with GRU
     judges over all eleven sections at --num-songs 1: results.json's
     numbers finite or null, a CSV row per evaluated song and the mean
     row, every .mid parses back, A 4 per encode + A 2 per judge call and
     B 3 per decode call; each section's wall seconds;
 44. the harness card against CPU: decode_batch's probabilities of every
     head at each bucket size phases 42 and 43 reached (PROBS_ATOL), and
     the autoencoding section over 3 songs with GRU judges (the rolls'
     agreement at MIN_ARGMAX_AGREEMENT, the accuracies of the songs without
     a flipped row within ACC_ATOL).
Then D's and M's route counters on the Config(), bf16 Config() and
residual_bf16 training slices and the LSTM transfer (every launch their
chains'), one JSON line with the kernels, and the final line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
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
LOGITS_ATOL = 1e-4  # kernel B's and M's logits
L_H_ATOL = 1e-5     # kernel L's h (and Q's, S's h)
C_ATOL = 5e-5       # the c sequence of L and Q, S's c: |c| grows over the steps
M_PROBS_ATOL = 1e-5  # kernel M's probs
# card vs CPU end to end (encoder dense layers + 64-step decode on top)
Z_ATOL = 1e-4
PROBS_ATOL = 1e-4
MIN_ARGMAX_AGREEMENT = 0.999
JUDGE_ATOL = 1e-5  # the judges' class probs, card vs CPU (two encoder layers + softmax)
# one training step, card vs CPU (f32, TF32 off, sums in another order over
# 64-step chains at full width): losses to LOSS_ATOL; accuracies to ACC_ATOL
# (about 16 of the 16,000 note steps may flip an argmax between near-ties);
# each parameter's gradient to STEP_GRAD_RTOL of its largest entry, plus
# STEP_GRAD_ATOL for parameters whose gradients are near zero
LOSS_ATOL = 1e-5
ACC_ATOL = 1e-3
STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-4, 1e-7
# training kernels (C, D, E, W) in f32 with TF32 off: gradients come back
# through 64-step chains (the decode heads feed their probs back), and the
# kernels sum in another order than autograd through the plain versions, so
# a gradient is held to max|diff| <= GRAD_RTOL * max(1, max|g|); the
# forward values of D to H_ATOL (probs, h) and LOGITS_ATOL (logits)
GRAD_RTOL = 1e-4
# bf16 (phases 26-28): the kernels and their plain versions both take the
# products and gates in float32 and round the carried state to bf16 once a
# step, but sum in another order, so a state entry may now and then round
# one bf16 step the other way and carry that on. Two limits, on every
# output: max |diff| <= BF16_ATOL (on the path's data |h| <= 0.11, where a
# bf16 step is <= 4.9e-4), and the relative L2 error |k - p| / |p| <=
# BF16_REL_L2, the one that tells a sound kernel from a wrong one. A sound
# kernel differs from its plain version in a share of entries by a rounding
# flip each, a share that grows over the 64 steps; a scan that rounds every
# op to bf16, or one that carries the state in float32 (no per-step
# rounding), differs in most of them. Phase 26 on the H100 (NVIDIA H100
# 80GB HBM3, 700 W) read: the kernels 7.5e-5 to 1.40e-3 (Y at LSTM(512),
# final h), the per-op scan 4.7e-3 to 6.4e-3, the float32-state
# scan 1.99e-3 to 2.82e-3; BF16_REL_L2 lies between. Phase 26 runs both
# faults as controls on notes L1 that must land over it. max |diff| alone
# cannot separate them at these magnitudes: the per-op fault stays within a
# few bf16 steps of 0.1, under BF16_ATOL.
# The remat backward is the JAX reference on both sides. One
# step card vs CPU: cuBLAS and the CPU round each bf16 product of the dense
# layers and the backward at their own sums' order: losses to
# BF16_LOSS_ATOL, accuracies to BF16_ACC_ATOL, each gradient's relative L2
# error to BF16_GRAD_REL_L2 and its max |diff| to BF16_GRAD_REL_MAX of its
# largest entry (about twice what one step of each bf16 config measured on
# the H100: |dloss| 1.4e-6, an accuracy off by 1e-3, every gradient within
# 1.2e-2 relative L2 and 2.3e-2 of its largest entry)
BF16_ATOL = 1.5e-3
BF16_REL_L2 = 1.7e-3
BF16 = (BF16_ATOL, BF16_REL_L2)
BF16_LOSS_ATOL, BF16_ACC_ATOL = 1e-4, 5e-3
BF16_GRAD_REL_L2, BF16_GRAD_REL_MAX = 2.5e-2, 5e-2
REPS = 20
# the plain versions' timing windows in compare() (two sets, in turns with
# the kernel's): they take milliseconds where the kernels take tens of
# microseconds, and vary less
PLAIN_REPS = 10
# a training step's timing windows, after one warm-up step: 5 steps of
# 60-500 ms each (a step's device time is profile_train's to measure)
STEP_REPS = 5
B = 256
RAGGED = 5  # rows of a batch smaller than one block's tile
H1024 = 1024  # the widest GRU the JAX package trains (tools/bench_width.py --sizes 512,1024)


def rel(w):
    """The gradient limit for a plain-version gradient w."""
    return GRAD_RTOL * max(1.0, w.abs().max().item())


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
    # every library and W's control build (B's cycle-counting build is the
    # timing tool's alone)
    names = (*_build.LIBRARIES, "grad_reduce_tf32one")
    _build.build(names)
    for name in names:
        _build.load(name)
    secs = {k: round(v, 2) for k, v in _build.build_seconds.items()}
    print(f"[build] {time.perf_counter() - t0:.2f} s, in parallel; nvcc per library: {secs}")
    found = check_registers()
    check_launch_bounds(found)
    found["clusters"] = report_clusters()
    return found


def report_clusters():
    """The cluster size of each of N's and R's chain builds and of Q's, Y's
    and L's forward chain builds at H = 256 and 512, whether its slice of U
    streams, and the card's cudaOccupancyMaxActiveClusters at that size (one
    CTA an SM), beside the count the route chooser's plans assume off the
    card, and each build's plan at B = 256."""
    import torch

    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import lstm_layer as ll

    found = {}
    for build in _layout.BPTT_BUILDS:
        lib = "lstm_layer_bwd" if build[0] == "N" else "lstm_layer_xp_bwd"
        for H in (256, 512):
            C, stream = _layout.bptt_cluster(build, H)
            active = ll._max_clusters(lib, build.endswith("_bf16"), C, stream)
            dtype = torch.bfloat16 if build.endswith("_bf16") else torch.float32
            plan = ll.chain_plan(build[0], H, B, dtype)
            found[f"{build} H={H}"] = {"cluster": C, "stream": stream, "max_active_clusters": active,
                                       "assumed": _layout.MAX_CLUSTERS_H100[C],
                                       "plan_B256": plan._asdict()}
    fwd = {}
    for build in _layout.FWD_BUILDS:
        for H in (256, 512):
            C, stream = _layout.fwd_cluster(build, H)
            active = ll._max_clusters(ll._FWD_LIBRARIES[build], build not in ("Q", "L_chain"), C,
                                      stream)
            plan = ll.fwd_chain_plan(build, H, B)
            fwd[f"{build} H={H}"] = {"cluster": C, "stream": stream, "max_active_clusters": active,
                                     "assumed": _layout.MAX_CLUSTERS_H100[C],
                                     "plan_B256": plan._asdict()}
    from midi_vae_tpu_torch.ops import gru_layer as gl

    for build in ("A_chain", "A_chain_bf16"):
        for H in (256, 512):
            C, stream = _layout.gru_fwd_cluster(build, H)
            active = gl._max_clusters("gru_layer_fwd", build.endswith("_bf16"), C, stream)
            plan = gl.gru_chain_plan(build, H, B)
            fwd[f"{build} H={H}"] = {"cluster": C, "stream": stream, "max_active_clusters": active,
                                     "assumed": _layout.MAX_CLUSTERS_H100[C],
                                     "plan_B256": plan._asdict()}
    # X: A's bf16 chain in X's library (the instance over a bf16 xp)
    from midi_vae_tpu_torch.ops import encoder_scan as es

    for H in (256, 512):
        plan = es.scan_chain_plan(H, B)
        fwd[f"X_chain H={H}"] = {
            "cluster": plan.cluster, "stream": False,
            "max_active_clusters": gl._max_clusters("gru_encoder_scan", True, plan.cluster),
            "assumed": _layout.MAX_CLUSTERS_H100[plan.cluster], "plan_B256": plan._asdict()}
    from midi_vae_tpu_torch.ops import gru_decode as gd

    # B's decode chain on the notes head (it streams every slice)
    for H in (256, 512):
        plan = gd.decode_plan(H, 61, 2, B)
        fwd[f"B_chain H={H} notes"] = {
            "cluster": plan.cluster, "stream": True,
            "max_active_clusters": gd.chain_max_clusters(plan.cluster),
            "assumed": _layout.MAX_CLUSTERS_H100[plan.cluster], "plan_B256": plan._asdict()}
    bwd = {}
    for build, H, heads in (("C_chain", 256, None), ("C_chain", 512, None),
                            ("C_chain_bf16", 256, None), ("C_chain_bf16", 512, None),
                            ("E_chain", 256, ((61, 2, 64), (1, 1, 64))),
                            ("E_chain", 512, ((61, 2, 64),)), ("E_chain_bf16", 256, ((61, 2, 64),)),
                            ("E_chain_bf16", 512, ((61, 2, 64),))):
        lib = "gru_layer_bwd" if build[0] == "C" else "gru_decode_bwd"
        plan = gl.gru_bptt_plan(build, H, B, heads)
        active = gl._max_clusters(lib, build.endswith("_bf16"), plan.cluster)
        bwd[f"{build} H={H}{' heads ' + str(heads) if heads else ''}"] = {
            "cluster": plan.cluster, "stream": not plan.resident, "max_active_clusters": active,
            "assumed": _layout.MAX_CLUSTERS_H100[plan.cluster], "plan_B256": plan._asdict()}
    # G: C's chain in G's library
    for bf16 in (False, True):
        for H in (256, 512):
            plan = gl.xp_bwd_plan(bf16, H, B)
            bwd[f"G_chain{'_bf16' if bf16 else ''} H={H}"] = {
                "cluster": plan.cluster, "stream": not plan.resident,
                "max_active_clusters": gl._max_clusters("gru_layer_xp_bwd", bf16, plan.cluster),
                "assumed": _layout.MAX_CLUSTERS_H100[plan.cluster], "plan_B256": plan._asdict()}
    print("[build] GRU backward chain plans (ops/_layout.py::gru_bptt_plan at B = "
          f"{B}; cudaOccupancyMaxActiveClusters at the plan's size): " + "; ".join(
              f"{k}: cluster {v['cluster']}, active {v['max_active_clusters']} (assumed "
              f"{v['assumed']}), rows {v['plan_B256']['rows']} x {v['plan_B256']['clusters']} "
              f"clusters, {'streamed' if v['stream'] else 'resident'} ring of "
              f"{v['plan_B256']['stages']}, nbuf {v['plan_B256']['nbuf']}, "
              f"{v['plan_B256']['smem']:,} bytes, {v['plan_B256']['waves']} wave(s)"
              for k, v in bwd.items()))
    print("[build] forward chain clusters (size, U streamed, cudaOccupancyMaxActiveClusters; "
          f"plan at B = {B}): " + "; ".join(
              f"{k}: {v['cluster']}, {v['stream']}, {v['max_active_clusters']}; rows "
              f"{v['plan_B256']['rows']} x {v['plan_B256']['clusters']} clusters, splits "
              f"{v['plan_B256']['splits']}, stages {v['plan_B256']['stages']}, "
              f"{v['plan_B256']['smem']:,} bytes" for k, v in fwd.items()))
    print("[build] chain clusters (size, U^T streamed, cudaOccupancyMaxActiveClusters; plan at "
          f"B = {B}): " + "; ".join(
              f"{k}: {v['cluster']}, {v['stream']}, {v['max_active_clusters']}; rows "
              f"{v['plan_B256']['rows']} x {v['plan_B256']['clusters']} clusters, splits "
              f"{v['plan_B256']['splits']}, nbuf {v['plan_B256']['nbuf']}, stages "
              f"{v['plan_B256']['stages']}, {v['plan_B256']['smem']:,} bytes"
              for k, v in found.items()))
    return found | fwd | bwd


# the route chooser's build letter -> (library, kernel function name[, a
# substring its mangled name must hold, or with "!" must not]): the f32
# builds of A to E and W leave their bf16 instances to the "_bf16" letters
NOT_BF16, BF16_ONLY = "!nv_bfloat16", "nv_bfloat16"
BUILDS = {"A": ("gru_layer_fwd", "gru_layer_fwd_kernel", NOT_BF16),
          # A's x @ W pre-pass (csrc/xproj.cuh, L's) and its chain
          # (csrc/gru_cell_fwd.cuh), and their bf16 instances
          "A_xproj": ("gru_layer_fwd", "xproj_kernel", NOT_BF16),
          "A_chain": ("gru_layer_fwd", "gru_fwd_chain_kernel", NOT_BF16),
          "A_xproj_bf16": ("gru_layer_fwd", "xproj_kernel", BF16_ONLY),
          "A_chain_bf16": ("gru_layer_fwd", "gru_fwd_chain_mma_kernel"),
          # B's decode chain on clusters (csrc/gru_decode_chain.cuh) and its
          # per-block route (the body kernel D shares)
          "B": ("gru_decode", "gru_decode_kernel"),
          "B_chain": ("gru_decode", "gru_decode_chain_kernel"),
          # C's phases (csrc/gru_cell_bwd_chain.cuh): the gate pre-pass's two
          # products (P1, P2), the chain, the dx pass; and E's: the same
          # pre-pass, the chain through the head (its float instance serves
          # E, E wide and E resid; bf16 with the streams unrounded, E bf16
          # and E wide row8; with them rounded, E wide bf16)
          "C_gates": ("gru_layer_bwd", "gru_gates_p1_kernel", NOT_BF16),
          "C_gates_p2": ("gru_layer_bwd", "gru_gates_p2_kernel", NOT_BF16),
          "C_chain": ("gru_layer_bwd", "gru_bwd_chain_kernel", NOT_BF16),
          "C_dx": ("gru_layer_bwd", "gru_bwd_dx_kernel", NOT_BF16),
          "D": ("gru_decode_train", "gru_decode_train_kernel", NOT_BF16),
          "E_gates": ("gru_decode_bwd", "gru_gates_p1_kernel", NOT_BF16),
          "E_gates_p2": ("gru_decode_bwd", "gru_gates_p2_kernel", NOT_BF16),
          "E_chain": ("gru_decode_bwd", "gru_head_bwd_chain_kernel", NOT_BF16),
          # F: its per-block route (the first design), its chain (A's float32
          # instances in F's library; at H = 512 the tensor-core instance)
          "F": ("gru_layer_xp_fwd", "gru_layer_xp_fwd_kernel"),
          "F_chain": ("gru_layer_xp_fwd", "gru_fwd_chain_kernel"),
          "F_chain_tc": ("gru_layer_xp_fwd", "gru_fwd_chain_tc_kernel"),
          # G: its per-block route (the first design), its xp gate pre-pass
          # (P1, P2) and its chain (C's, in G's library; the bf16 instance
          # also emits dxp)
          "G": ("gru_layer_xp_bwd", "gru_layer_xp_bwd_kernel", NOT_BF16),
          "G_gates": ("gru_layer_xp_bwd", "gru_xp_gates_p1_kernel", NOT_BF16),
          "G_gates_p2": ("gru_layer_xp_bwd", "gru_xp_gates_p2_kernel", NOT_BF16),
          "G_chain": ("gru_layer_xp_bwd", "gru_bwd_chain_kernel", NOT_BF16),
          "D_wide": ("gru_decode_train", "gru_decode_train_wide_kernel", NOT_BF16),
          # D's chain (every build's): B's decode chain in its training
          # instances (FFMA: float32, bf16, float32 with bf16 h sequences for
          # D resid) and its tensor-core instance, float32 and bf16
          "D_wide_chain": ("gru_decode_train", "gru_decode_chain_kernel", NOT_BF16),
          "D_wide_chain_bf16": ("gru_decode_train", "gru_decode_chain_kernel", BF16_ONLY),
          "D_chain_resid": ("gru_decode_train", "gru_decode_chain_kernel",
                            "fLb1E13__nv_bfloat16"),
          "D_wide_tc": ("gru_decode_train", "gru_decode_chain_tc_kernel", NOT_BF16),
          "D_wide_tc_bf16": ("gru_decode_train", "gru_decode_chain_tc_kernel", BF16_ONLY),
          "W": ("grad_reduce", "grad_reduce", NOT_BF16),
          # W's instances: the tiles on the tensor cores, the small-I stream,
          # and the one-TF32-product control build
          "W_tc": ("grad_reduce", "grad_reduce_tc_kernel", NOT_BF16),
          "W_small": ("grad_reduce", "grad_reduce_small_kernel", NOT_BF16),
          "W_tf32one": ("grad_reduce_tf32one", "grad_reduce_tc_kernel", NOT_BF16),
          # L's per-block route (its first design), its x @ W pre-pass and its
          # chain (csrc/lstm_cell_fwd.cuh, the float32 xp of the pre-pass)
          "L": ("lstm_layer_fwd", "lstm_layer_fwd_kernel", NOT_BF16),
          "L_xproj": ("lstm_layer_fwd", "xproj_kernel", NOT_BF16),
          "L_chain": ("lstm_layer_fwd", "lstm_fwd_chain_kernel"),
          "M": ("lstm_decode", "lstm_decode_kernel"),
          # M's decode chain on clusters (csrc/lstm_decode_chain.cuh)
          "M_chain": ("lstm_decode", "lstm_decode_chain_kernel"),
          # N's and R's phases (csrc/lstm_cell_bwd.cuh): the gate pre-pass
          # (FFMA in float32, tensor cores in bf16), the chain, N's dx pass
          "N_gates": ("lstm_layer_bwd", "lstm_bwd_gates_kernel"),
          "N_chain": ("lstm_layer_bwd", "lstm_bwd_chain_kernel", NOT_BF16),
          "N_dx": ("lstm_layer_bwd", "lstm_bwd_dx_kernel", NOT_BF16),
          # Q's and Y's forward chain (csrc/lstm_cell_fwd.cuh): FFMA in float32,
          # tensor cores in bf16
          "Q": ("lstm_layer_xp_fwd", "lstm_fwd_chain_kernel"),
          "R_gates": ("lstm_layer_xp_bwd", "lstm_bwd_gates_kernel"),
          "R_chain": ("lstm_layer_xp_bwd", "lstm_bwd_chain_kernel", NOT_BF16),
          # S and S xp: one product on the tensor cores (gemm_tc.cuh) with
          # the cell in its epilogue, three tile instances each
          "S": ("lstm_step", "lstm_step_kernel", NOT_BF16),
          "S_xp": ("lstm_step", "lstm_step_xp_kernel"),
          # T, T xp (and T bf16 below): one step on clusters and the tensor
          # cores, six plan instances each (the template's bool: xp)
          "T": ("gru_step", "gru_step_tc_kernel", NOT_BF16, "Lb0E"),
          "T_xp": ("gru_step", "gru_step_tc_kernel", "Lb1E"),
          # X: its per-block route (the first design) and its chain (A's
          # bf16 chain, the instance that reads a bf16 xp)
          "X": ("gru_encoder_scan", "gru_encoder_scan_kernel"),
          "X_chain": ("gru_encoder_scan", "gru_fwd_chain_mma_kernel"),
          # X's streamed instance at H = 1024: F's tensor-core chain over bf16
          "X_chain_tc": ("gru_encoder_scan", "gru_fwd_chain_tc_kernel"),
          "Y": ("lstm_encoder_scan", "lstm_fwd_chain_mma_kernel"),
          "U": ("gru_encoder_stack_fwd", "gru_encoder_stack_fwd_kernel"),
          "V": ("gru_encoder_stack_bwd", "gru_encoder_stack_bwd_kernel"),
          # the bf16 instances of T's, S's, A's, C's, D's, E's, G's, the wide
          # D's and E's, W's, L's, N's, Q's and R's kernels
          "T_bf16": ("gru_step", "gru_step_tc_kernel", BF16_ONLY),
          "S_bf16": ("lstm_step", "lstm_step_kernel", BF16_ONLY),
          "A_bf16": ("gru_layer_fwd", "gru_layer_fwd_kernel", BF16_ONLY),
          "C_gates_bf16": ("gru_layer_bwd", "gru_gates_p1_kernel", BF16_ONLY),
          "C_gates_p2_bf16": ("gru_layer_bwd", "gru_gates_p2_kernel", BF16_ONLY),
          "C_chain_bf16": ("gru_layer_bwd", "gru_bwd_chain_kernel", BF16_ONLY),
          "C_dx_bf16": ("gru_layer_bwd", "gru_bwd_dx_kernel", BF16_ONLY),
          "D_bf16": ("gru_decode_train", "gru_decode_train_kernel", BF16_ONLY),
          "E_gates_bf16": ("gru_decode_bwd", "gru_gates_p1_kernel", BF16_ONLY),
          "E_gates_p2_bf16": ("gru_decode_bwd", "gru_gates_p2_kernel", BF16_ONLY),
          "E_chain_bf16": ("gru_decode_bwd", "gru_head_bwd_chain_kernel", "nv_bfloat16fLb0E"),
          "E_chain_wide_bf16": ("gru_decode_bwd", "gru_head_bwd_chain_kernel",
                                "nv_bfloat16S1_Lb0E"),
          # their per-segment instances (a head's partial wider than the
          # CTA's warps hold: a 1-layer head at H = 1024)
          "E_chain_bf16_seg": ("gru_decode_bwd", "gru_head_bwd_chain_kernel", "nv_bfloat16fLb1E"),
          "E_chain_wide_bf16_seg": ("gru_decode_bwd", "gru_head_bwd_chain_kernel",
                                    "nv_bfloat16S1_Lb1E"),
          "W_bf16": ("grad_reduce", "grad_reduce", BF16_ONLY),
          "W_tc_bf16": ("grad_reduce", "grad_reduce_tc_kernel", BF16_ONLY),
          "W_small_bf16": ("grad_reduce", "grad_reduce_small_kernel", BF16_ONLY),
          "G_bf16": ("gru_layer_xp_bwd", "gru_layer_xp_bwd_kernel", BF16_ONLY),
          "G_gates_bf16": ("gru_layer_xp_bwd", "gru_xp_gates_p1_kernel", BF16_ONLY),
          "G_gates_p2_bf16": ("gru_layer_xp_bwd", "gru_xp_gates_p2_kernel", BF16_ONLY),
          "G_chain_bf16": ("gru_layer_xp_bwd", "gru_bwd_chain_kernel", BF16_ONLY),
          "D_wide_bf16": ("gru_decode_train", "gru_decode_train_wide_kernel", BF16_ONLY),
          "L_bf16": ("lstm_layer_fwd", "lstm_layer_fwd_kernel", BF16_ONLY),
          "L_xproj_bf16": ("lstm_layer_fwd", "xproj_kernel", BF16_ONLY),
          "L_chain_bf16": ("lstm_layer_fwd", "lstm_fwd_chain_mma_kernel"),
          "N_gates_bf16": ("lstm_layer_bwd", "lstm_bwd_gates_mma_kernel"),
          "N_chain_bf16": ("lstm_layer_bwd", "lstm_bwd_chain_kernel", BF16_ONLY),
          "N_dx_bf16": ("lstm_layer_bwd", "lstm_bwd_dx_kernel", BF16_ONLY),
          "Q_bf16": ("lstm_layer_xp_fwd", "lstm_fwd_chain_mma_kernel"),
          "R_gates_bf16": ("lstm_layer_xp_bwd", "lstm_bwd_gates_mma_kernel"),
          "R_chain_bf16": ("lstm_layer_xp_bwd", "lstm_bwd_chain_kernel", BF16_ONLY),
          # D's bf16-residual build (decode_residual_bf16)
          "D_resid": ("gru_decode_train", "gru_decode_train_resid_kernel")}


# the instances that must not spill: W's, L's, A's, S's, C's, E's, T's,
# B's, F's, D's, M's, X's and G's of the tensor-core and chain designs
NO_SPILLS = ("T", "T_xp", "T_bf16", "B_chain", "X_chain", "F_chain", "F_chain_tc",
             "D_wide_chain", "D_wide_chain_bf16", "D_wide_tc", "D_wide_tc_bf16",
             "D_chain_resid", "M_chain",
             *(f"G_{p}{s}" for p in ("gates", "gates_p2", "chain") for s in ("", "_bf16")),
             "W_tc", "W_small", "W_tf32one", "W_tc_bf16", "W_small_bf16", "L_xproj", "L_chain",
             "L_xproj_bf16", "L_chain_bf16", "A_xproj", "A_chain", "A_xproj_bf16", "A_chain_bf16",
             "S", "S_xp", "S_bf16", *(f"{k}_{p}{s}" for k in "CE" for p in ("gates", "gates_p2")
                                      for s in ("", "_bf16")),
             "C_chain", "C_chain_bf16", "C_dx", "C_dx_bf16", "E_chain", "E_chain_bf16",
             "E_chain_wide_bf16", "X_chain_tc", "E_chain_bf16_seg", "E_chain_wide_bf16_seg")


def check_registers():
    """Registers and spills of every build from ptxas (largest over a
    kernel's template instances); the route chooser's table must not count
    fewer registers than the builds use, and the launch-bounded builds must
    fit 512 threads."""
    from midi_vae_tpu_torch.ops import _build, _layout

    found = {}
    for letter, (lib, fn, *only) in BUILDS.items():
        entries = [v for k, v in _build.ptxas_report.get(lib, {}).items()
                   if (f"{len(fn)}{fn}" in k or (letter in ("W", "W_bf16") and fn in k))
                   and all(o[1:] not in k if o.startswith("!") else o in k for o in only)]
        if not entries:
            raise RuntimeError(f"no ptxas report for kernel {letter} ({fn} in lib{lib}.so)")
        found[letter] = {"registers": max(e["registers"] for e in entries),
                         "spill_bytes": max(e.get("spill_stores", 0) for e in entries)}
    for letter, regs in _layout.REGISTERS.items():
        if found[letter]["registers"] > regs:
            raise RuntimeError(f"kernel {letter} uses {found[letter]['registers']} registers, the "
                               f"route chooser counts {regs} (ops/_layout.py REGISTERS)")
    for letter in _layout.BOUNDED:
        if found[letter]["registers"] * _layout.WIDE_THREADS > _layout.REGS_PER_SM:
            raise RuntimeError(f"kernel {letter}: {found[letter]} does not fit 512 threads")
    chains = {**_layout.BPTT_PHASE_THREADS,
              **dict.fromkeys((*_layout.FWD_BUILDS, *_layout.GRU_FWD_BUILDS,
                               *_layout.GRU_BPTT_BUILDS, "E_chain_wide_bf16"),
                              _layout.CHAIN_THREADS),
              # the GRU backward's pre-pass and dx pass (G: its xp
              # pre-pass): 256-thread blocks; X's and G's chains
              **{f"{k}_{p}{s}": _layout.GEMM_THREADS for k in "CEG"
                 for p in ("gates", "gates_p2", "dx") for s in ("", "_bf16")
                 if not (k in "EG" and p == "dx")},
              **dict.fromkeys(("X_chain", "G_chain", "G_chain_bf16", "F_chain", "F_chain_tc",
                               "D_wide_chain", "D_wide_chain_bf16", "D_chain_resid",
                               "M_chain", "X_chain_tc", "E_chain_bf16_seg",
                               "E_chain_wide_bf16_seg"), _layout.CHAIN_THREADS),
              **dict.fromkeys(("D_wide_tc", "D_wide_tc_bf16"), _layout.DEC_TC_THREADS),
              # S's largest block (its instances: 64 or 128 threads)
              **dict.fromkeys(_layout.STEP_BUILDS,
                              max(p[1] for p in _layout.STEP_TILES) * 8),
              # B's chain: 512-thread CTAs (T's instances are each compiled
              # under __launch_bounds__ of their own block, 64 to 512)
              "B_chain": _layout.CHAIN_THREADS}
    for letter, threads in chains.items():
        if found[letter]["registers"] * threads > _layout.REGS_PER_SM:
            raise RuntimeError(f"kernel {letter}: {found[letter]} does not fit {threads} threads")
    print("[build] registers (spill bytes) per thread: " + ", ".join(
        f"{k} {v['registers']} ({v['spill_bytes']})" for k, v in found.items()))
    for letter in NO_SPILLS:
        if found[letter]["spill_bytes"]:
            raise RuntimeError(f"kernel {letter} spills: {found[letter]}")
    return found


def check_launch_bounds(found):
    """The C entry points of D's 8-rows per-block builds (and of its bf16
    and bf16-residual builds where ptxas's registers allow fewer than 512
    threads) refuse H = 512 before any launch
    (cudaErrorLaunchOutOfResources), as the route chooser says (D's chain
    takes every path's width). E runs as phases, its chain on clusters at
    every width its plan takes."""
    import ctypes

    import torch

    from midi_vae_tpu_torch.ops import _layout, gru_decode

    out_of_resources = 701  # cudaErrorLaunchOutOfResources
    refused = []
    for letter in ("D", "D_bf16", "D_resid"):
        struct = gru_decode._DecodeHead
        dtype = torch.bfloat16 if letter.endswith("_bf16") else torch.float32
        chooser = _layout.launch_limit(letter, 512, _layout.smem_bytes(letter, 512, 61, 2))
        if dtype == torch.float32 and chooser is None:
            raise RuntimeError(f"the route chooser lets kernel {letter} launch at H = 512")
        if found[letter]["registers"] * 512 <= _layout.REGS_PER_SM:
            continue  # it would launch: no call with null pointers
        if chooser is None:
            raise RuntimeError(f"the route chooser lets kernel {letter} launch at H = 512, "
                               f"its build uses {found[letter]['registers']} registers")
        head = struct(D=61, n_layers=2, out_act=gru_decode.OUT_ACTIVATIONS["softmax"], T=64)
        rc = gru_decode._d_entries(letter)[2](ctypes.byref(head), 1, B, 512, None)
        if rc != out_of_resources:
            raise RuntimeError(f"kernel {letter} (8 rows) at H = 512 returned {rc}, "
                               f"not {out_of_resources} (cudaErrorLaunchOutOfResources)")
        refused.append(letter)
    print(f"[build] {', '.join(refused)} (8 rows) refuse H = 512 at their C entry points")
    for letter in ("E", "E_bf16", "E_resid"):
        if _layout.launch_limit(letter, 512, 0) is not None:
            raise RuntimeError(f"the route chooser keeps E's chain build {letter} from H = 512")


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


def median_ms(fn, reps=REPS):
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# the least time the card could take for a kernel's work: the larger of its
# operations over the H100 SXM's float32 rate outside the tensor cores (the
# f32 kernels, TF32 off) or, for the bf16 kernels, its dense bf16 tensor-core
# rate, and the bytes it must move (each input read once, each output
# written once, at each tensor's element size) over HBM3's rate; NVIDIA's
# published peaks at the full 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# the dense TF32 tensor-core rate: kernel W and L's pre-pass take a float32
# product as three TF32 products (a bf16 A: two), so their bound is those
# products at this rate (tf32_work) where it exceeds the bytes'
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12


def tensors_in(*objs):
    """The distinct tensors (by storage address) inside nested lists, tuples
    and dicts."""
    import torch

    found, seen = [], set()

    def walk(o):
        if isinstance(o, torch.Tensor):
            if o.data_ptr() not in seen:
                seen.add(o.data_ptr())
                found.append(o)
        elif isinstance(o, (dict, torch.nn.ParameterDict, torch.nn.ModuleDict)):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple, torch.nn.ModuleList)):
            for v in o:
                walk(v)

    for o in objs:
        walk(o)
    return found


def nbytes(*objs):
    return sum(t.numel() * t.element_size() for t in tensors_in(*objs))


def bound(flops, moved, peak=PEAK_F32_FLOPS, flops_f32=0.0):
    """(bound_ms, bound_by) of ``flops`` operations at ``peak`` FLOP/s, plus
    ``flops_f32`` at the float32 rate (a bf16 kernel's products with a
    float32 operand), and ``moved`` bytes."""
    t_ops = flops / peak + flops_f32 / PEAK_F32_FLOPS
    t_bytes = moved / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def calls_bound(calls):
    """bound() of the summed work of compare() results."""
    return bound(sum(r["flops"] / r["peak_flops"] for r in calls) * PEAK_F32_FLOPS
                 + sum(r.get("flops_f32", 0.0) for r in calls),
                 sum(r["bytes"] for r in calls))


# operations of the kernels' products (2 per multiply-add; the gate math is a
# few per element and left out), from the weights' shapes: W (d_in, G),
# U (H, G), G = 3H (GRU) or 4H (LSTM)
def layer_flops(T, B, w, u):
    """A layer forward with x @ W inside (A, L)."""
    return 2 * T * B * (w.shape[0] + u.shape[0]) * u.shape[1]


def decode_flops(T, B, cells, wo):
    """A decode head forward (B, D, M): its cells and its output dense."""
    return 2 * T * B * (sum((c["w"].shape[0] + c["u"].shape[0]) * c["u"].shape[1] for c in cells)
                        + wo.shape[0] * wo.shape[1])


def cell_bwd_flops(T, B, w, u, dx=True):
    """BPTT of a GRU cell (V): x @ W again, dx = da @ W^T, and four
    products with U or U^T: 2G d_in + 2G H multiply-adds a row and step."""
    return 2 * T * B * (w.shape[1] * w.shape[0] * (2 if dx else 1) + 2 * u.shape[1] * u.shape[0])


def gru_bwd_products(M, D, H):
    """The products of one GRU layer's backward over M = T B rows (2 per
    multiply-add): the gate pre-pass's P1 (x W and hprev U_zr) and P2 ((r h)
    U_h), the chain's da U^T, the layer's dx (da W^T)."""
    return 2 * M * (D * 3 * H + H * 2 * H), 2 * M * H * H, 2 * M * 3 * H * H, 2 * M * 3 * H * D


def gru_bwd_work(bf16, prepass=(0.0, 0.0), chain=0.0, readout=0.0, dx=0.0, best=False):
    """compare()'s work of kernel C's or E's phases, or of the whole op
    (their sum): ``prepass`` the pre-pass's (P1, P2), ``chain`` the chain's
    products with U^T and W^T, ``readout`` E's dlogits Wo^T (FFMA in both
    builds), ``dx`` C's dx pass. float32: the pre-pass and the dx pass as
    three TF32 products each, the chain at the FFMA rate; bf16: P1 one bf16
    product (exact operands), P2 and the dx pass two (a float operand split
    in two), the chain three (da split in three), at the bf16 rate. With
    ``best`` every product at the card's best rate for its operand types,
    as f_work, g_work and d_work price theirs: float32's chain and readout
    as three TF32 products, bf16's readout (float dlogits against bf16 Wo)
    as two bf16 products."""
    p1, p2 = prepass
    if bf16:
        if best:
            return {"flops": p1 + 2 * p2 + 3 * chain + 2 * dx + 2 * readout,
                    "peak": PEAK_BF16_FLOPS}
        return {"flops": p1 + 2 * p2 + 3 * chain + 2 * dx, "peak": PEAK_BF16_FLOPS,
                "flops_f32": readout}
    if best:
        return tf32_work(p1 + p2 + dx + chain + readout)
    return {"flops": 3 * (p1 + p2 + dx), "peak": PEAK_TF32_FLOPS, "flops_f32": chain + readout}


def c_work(x, u, need_dx, phase=None):
    """gru_bwd_work of C on x (T, B, D) and U: the whole op, or one
    ``phase`` ("gates", "chain", "dx")."""
    import torch

    T, rows, D = x.shape
    p1, p2, chain, dx = gru_bwd_products(T * rows, D, u.shape[0])
    parts = {"gates": {"prepass": (p1, p2)}, "chain": {"chain": chain},
             "dx": {"dx": dx if need_dx else 0.0}}
    kw = parts[phase] if phase else {k: v for p in parts.values() for k, v in p.items()}
    return gru_bwd_work(x.dtype == torch.bfloat16, **kw)


def e_work(heads, phase=None, best=False):
    """gru_bwd_work of E on a call's heads (dicts with cells, out, start,
    T): the whole op, or one ``phase`` ("gates", "chain"), each product at
    the card's best rate with ``best``. The chain takes each layer's da U^T
    and its dx (da W^T) and the readout's transpose."""
    import torch

    P1 = P2 = chain = readout = 0.0
    for h in heads:
        M = h["T"] * h["start"].shape[0]
        for c in h["cells"]:
            p1, p2, ch, dx = gru_bwd_products(M, c["w"].shape[0], c["u"].shape[0])
            P1, P2, chain = P1 + p1, P2 + p2, chain + ch + dx
        readout += 2 * M * h["out"]["w"].numel()
    parts = {"gates": {"prepass": (P1, P2)}, "chain": {"chain": chain, "readout": readout}}
    kw = parts[phase] if phase else {k: v for p in parts.values() for k, v in p.items()}
    return gru_bwd_work(heads[0]["start"].dtype == torch.bfloat16, **kw, best=best)


def g_work(xp, u, phase=None):
    """compare()'s work of G on xp (T, B, 3H) and U: the whole op, or one
    ``phase`` ("gates", "chain"): C's products with no x segment and no dx
    pass, each at the card's best rate for its operand types. float32:
    every product (P1, P2, the chain's da U^T) as three TF32 products;
    bf16: P1 one bf16 product (exact operands), P2 two (r h float against
    bf16 U_h), the chain three (da in three terms, as the chain's carry
    needs float accuracy)."""
    import torch

    T, rows, _ = xp.shape
    p1, p2, chain, _dx = gru_bwd_products(T * rows, 0, u.shape[0])
    if phase == "gates":
        chain = 0.0
    elif phase == "chain":
        p1 = p2 = 0.0
    if xp.dtype == torch.bfloat16:
        return {"flops": p1 + 2 * p2 + 3 * chain, "peak": PEAK_BF16_FLOPS}
    return tf32_work(p1 + p2 + chain)


def x_work(T, rows, H):
    """compare()'s work of X (a bf16 layer over xp), each product at the
    card's best rate for its operand types: h @ U[:, :2H] one bf16 product
    (both operands bf16), (r * h) @ U[:, 2H:] two (r * h float against bf16
    U_h)."""
    return {"flops": 4 * T * rows * H * H + 2 * (2 * T * rows * H * H), "peak": PEAK_BF16_FLOPS}


def f_work(T, rows, H):
    """compare()'s work of F (a float32 layer over xp), at the card's best
    rate for its operand types: h @ U[:, :2H] and (r * h) @ U[:, 2H:], f32
    x f32, each as three TF32 products."""
    return tf32_work(2 * T * rows * H * 3 * H)


def d_work(heads):
    """compare()'s work of D (every build) on a call's heads (dicts with cells,
    out, start, T), each product at the card's best rate for its operand
    types. float32: every product (the layers' x W and h U, the readout) as
    three TF32 products. bf16: bf16 x bf16 (layer 1's x W over the fed-back
    probs, every h @ U[:, :2H] over the carried h) one bf16 product; float x
    bf16 (layer 2's x W over layer 1's float h, (r * h) @ U[:, 2H:], the
    readout over the float top h) two."""
    import torch

    one = two = 0.0
    for h in heads:
        M = h["T"] * h["start"].shape[0]
        two += 2 * M * h["out"]["w"].numel()
        for i, c in enumerate(h["cells"]):
            H = c["u"].shape[0]
            one += 2 * M * 2 * H * H
            two += 2 * M * H * H
            if i == 0:
                one += 2 * M * c["w"].numel()
            else:
                two += 2 * M * c["w"].numel()
    if heads[0]["start"].dtype == torch.bfloat16:
        return {"flops": one + 2 * two, "peak": PEAK_BF16_FLOPS}
    return tf32_work(one + two)


def check(name, kernel_fn, plain_fn, limits, **_timed_only):
    """Kernel vs plain on the same inputs: max |diff| per output, within limits."""
    return _check(name, kernel_fn, plain_fn, limits)[0]


def rel_l2(got, want):
    """|got - want| / |want| in float32 (Frobenius norms)."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def _check(name, kernel_fn, plain_fn, limits):
    """Returns (max |diff| per output, relative L2 error per output held to
    a (max |diff|, relative L2) limit such as BF16, the kernel's outputs)."""
    import torch

    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want) or len(limits) != len(want):
        raise RuntimeError(f"{name}: {len(got)} kernel outputs, {len(want)} plain, {len(limits)} limits")
    errs, rels = [], []
    for g, w, limit in zip(got, want, limits):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"{name}: kernel output {tuple(g.shape)} not finite or not {tuple(w.shape)}")
        if isinstance(limit, tuple):
            limit, rel_limit = limit
            rels.append(rel_l2(g, w))
            if not rels[-1] <= rel_limit:
                raise RuntimeError(f"{name}: relative L2 |kernel - plain| / |plain| = "
                                   f"{rels[-1]:.3e} > {rel_limit:.3e}")
        limit = limit(w) if callable(limit) else limit
        err = (g - w).abs().max().item()
        if not err <= limit:
            raise RuntimeError(f"{name}: max |kernel - plain| = {err:.3e} > {limit:.3e}")
        errs.append(err)
    return errs, rels, got


def _shown_limit(limit):
    """A limit as compare() prints it: "rel" for a function of the plain
    output, a (max |diff|, relative L2) pair, or a number."""
    if isinstance(limit, tuple):
        return f"{_shown_limit(limit[0])} & rel L2 {limit[1]:.1e}"
    return "rel" if callable(limit) else f"{limit:.1e}"


def compare(name, kernel_fn, plain_fn, limits, flops, inputs, library_fn=None,
            peak=PEAK_F32_FLOPS, flops_f32=0.0, reps=REPS, plain_reps=PLAIN_REPS):
    """check(), then both timed in turns (plain, kernel, kernel, plain; the
    medians of ``reps`` and ``plain_reps`` runs), with the bound of the
    call's work: ``flops`` operations at ``peak`` FLOP/s (and ``flops_f32``
    at the float32 rate), ``inputs`` (nested tensors) read and the kernel's
    outputs written; ``library_fn``, one PyTorch call that computes the same
    function, is timed beside them."""
    errs, rels, got = _check(name, kernel_fn, plain_fn, limits)
    plain_a, kernel_a = median_ms(plain_fn, plain_reps), median_ms(kernel_fn, reps)
    kernel_b, plain_b = median_ms(kernel_fn, reps), median_ms(plain_fn, plain_reps)
    ms, plain_ms = (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2
    moved = nbytes(inputs) + nbytes(got)
    bound_ms, bound_by = bound(flops, moved, peak, flops_f32)
    library_ms = median_ms(library_fn, reps) if library_fn is not None else None
    shown = ", ".join(_shown_limit(x) for x in limits)
    lib = f", library {library_ms:.4f} ms" if library_ms is not None else ""
    rel = f", rel L2 {', '.join(f'{e:.3e}' for e in rels)}" if rels else ""
    print(f"[kernels] {name}: max|diff| {', '.join(f'{e:.3e}' for e in errs)}{rel} "
          f"(limits {shown}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {(flops + flops_f32) / 1e9:.3f} GFLOP, "
          f"{moved / 1e6:.3f} MB)")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "flops": flops,
            "bytes": moved, "bound_ms": bound_ms, "library_ms": library_ms, "peak_flops": peak,
            **({"flops_f32": flops_f32} if flops_f32 else {}),
            **({"rel_l2": max(rels)} if rels else {})}


# W's reductions at the paths' shapes: (what, N rows, I, J, B's row stride
# (J where B is whole, wider where it is a column slice of the gate grads),
# bias sums, A's dtype, A's values)
W_CASES = (
    ("GRU(256) dW, notes L1: x (16384, 61)", 16384, 61, 768, 768, True, "float32", "one-hot"),
    ("GRU(256) dU[:, :2H]: h_{t-1}, da[:, :2H]", 16384, 256, 512, 768, False, "float32", "tanh"),
    ("GRU(256) dU[:, 2H:]: r*h, da[:, 2H:]", 16384, 256, 256, 768, False, "float32", "tanh"),
    ("notes head dWo, db: h (16384, 256), dlogits (16384, 61)", 16384, 256, 61, 61, True,
     "float32", "tanh"),
    ("velocity layer dW, db: x (16384, 1)", 16384, 1, 768, 768, True, "float32", "uniform"),
    ("instrument layer dW, db: x (1024, 16)", 1024, 16, 768, 768, True, "float32", "one-hot"),
    ("LSTM(512) dU", 16384, 512, 2048, 2048, False, "float32", "tanh"),
    ("LSTM judge dU, B = 512", 32768, 256, 1024, 1024, False, "float32", "tanh"),
    ("bf16 LSTM(256) dW, db, notes L1", 16384, 61, 1024, 1024, True, "bfloat16", "one-hot"),
    ("bf16 LSTM(256) dU", 16384, 256, 1024, 1024, False, "bfloat16", "tanh"),
    ("bf16 velocity layer dW, db", 16384, 1, 1024, 1024, True, "bfloat16", "uniform"),
)


def w_variant(lib_name, a, b, out, bias_out=None):
    """W from one of its variant libraries (``_build.VARIANTS``: the
    one-TF32-product control), called as the wrapper calls W's build of a's
    dtype; no path loads them."""
    import ctypes

    import torch

    from midi_vae_tpu_torch.ops import _build
    from midi_vae_tpu_torch.ops import grad_reduce as gr

    entry = "mvt_grad_reduce_bf16" if a.dtype == torch.bfloat16 else "mvt_grad_reduce"
    lib, fn = _build.load_entry(lib_name, entry,
                                [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    (N, I), J = a.shape, b.shape[1]
    splits = gr.splits(N, I, J, bias_out is not None)
    ie = I + (bias_out is not None)
    part = torch.empty(splits * ie * J, device=a.device) if splits > 1 else None
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else None)  # noqa: E731
    rc = fn(ptr(a), a.stride(0), ptr(b), b.stride(0), ptr(out), out.stride(0), ptr(bias_out),
            ptr(part), N, I, J, splits, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(lib, rc, f"{lib_name} launch")


def phase_grad_reduce_checks():
    """Kernel W (csrc/grad_reduce.cu) on each of W_CASES from seeded inputs,
    against a float64 sum on the card: C and the bias sums within W_REL_L2
    relative L2; two runs of the same reduction bit-equal (the partial sums
    added in a fixed order, no atomics); the control: the one-TF32-product
    build, on the float32 cases that take the tensor cores (I > 16), must
    land over W_REL_L2. Each timed (CUDA events, median of REPS, in turns)
    beside cuBLAS's a.t() @ b (+ b.sum(0) for the bias), and the control
    beside them. Returns {case: relative L2s and ms}."""
    import torch

    from midi_vae_tpu_torch.ops import grad_reduce as gr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    found = {}
    for what, N, I, J, ldb, with_bias, dtype, kind in W_CASES:
        if kind == "one-hot":
            a = torch.nn.functional.one_hot(
                torch.randint(0, I, (N,), generator=gen, device=dev), I).float()
        elif kind == "tanh":
            a = torch.tanh(torch.randn(N, I, generator=gen, device=dev))
        else:
            a = torch.rand(N, I, generator=gen, device=dev)
        a = a.to(getattr(torch, dtype))
        b = (1e-2 * torch.randn(N, ldb, generator=gen, device=dev))[:, ldb - J:]
        want = a.double().t() @ b.double()
        want_bias = b.double().sum(0)
        out = torch.empty(I, J + 7, device=dev)[:, 7:]  # a column slice, as du[:, 2H:]
        bias = torch.empty(J, device=dev) if with_bias else None

        def run(fn=gr.grad_reduce, a=a, b=b, out=out, bias=bias):
            fn(a, b, out, bias)
            return out.clone(), bias.clone() if bias is not None else None

        got, got_bias = run()
        again, bias_again = run()
        torch.cuda.synchronize()
        errs = {"rel_l2": rel_l2(got.double(), want)}
        if with_bias:
            errs["bias_rel_l2"] = rel_l2(got_bias.double(), want_bias)
        if not (torch.isfinite(got).all() and max(errs.values()) <= W_REL_L2):
            raise RuntimeError(f"W {what}: relative L2 {errs} from the float64 sum, over "
                               f"{W_REL_L2:.1e}")
        if not (torch.equal(got, again) and (not with_bias or torch.equal(got_bias, bias_again))):
            raise RuntimeError(f"W {what}: two runs of the same reduction differ")
        af = a.float()
        library = (lambda: (af.t() @ b, b.sum(0))) if with_bias else (lambda: af.t() @ b)
        timed = {"kernel": lambda: gr.grad_reduce(a, b, out, bias), "cuBLAS": library}
        if dtype == "float32" and I > gr.SMALL_I:
            ctrl, _ = run(lambda *x: w_variant("grad_reduce_tf32one", *x))
            torch.cuda.synchronize()
            errs["one TF32 product rel_l2"] = rel_l2(ctrl.double(), want)
            if not errs["one TF32 product rel_l2"] > W_REL_L2:
                raise RuntimeError(f"W {what}: the one-TF32-product control lands "
                                   f"{errs['one TF32 product rel_l2']:.3e} from the float64 "
                                   f"sum, inside {W_REL_L2:.1e}")
            timed["one TF32 product"] = lambda: w_variant("grad_reduce_tf32one", a, b, out, bias)
        first = {k: median_ms(f) for k, f in timed.items()}
        second = {k: median_ms(f) for k, f in reversed(timed.items())}
        ms = {f"{k} ms": (first[k] + second[k]) / 2 for k in timed}
        found[what] = errs | ms
        print(f"[W] {what} ({dtype} A, splits {gr.splits(N, I, J, with_bias)}): "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (limit {W_REL_L2:.1e}; the one-product control must exceed it); two runs "
              "bit-equal; " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return found


# sha256 prefixes of kernel A's outputs (its pre-pass, its chain with the
# sequence and with the final h) and kernel C's (dx, dh0, the gate grads and
# r * h; with the sequence's grad and with the final h's), float32 and bf16,
# on numpy-seeded inputs at (T 64, B 256, H 256 and 512), and of kernel E's
# (dlogits, the gate grads, r * h, the initial states' and start's grads) on
# a numpy-seeded 2-layer notes head through each of its chain instances
# (midi_vae_tpu_torch/tools/time_x_and_g.py --only digests), as the commit
# before X and G moved onto A's and C's chains computed them on an NVIDIA
# H100 80GB HBM3 at 700.00 W. X and G share A's, C's and E's device code
# (E's chain runs C's layer step); A, C and E were not to change, so their
# bits must not either. Then kernel B's chain outputs (probs and logits of
# numpy-seeded notes, velocity and instrument heads at H 256 and 512, B 256;
# midi_vae_tpu_torch/tools/time_f_and_d.py --only digests, the commit
# before F and D wide moved onto A's and B's chains, from its git archive
# copy on the same card in one call): F shares A's device code, D wide's
# chain B's, and neither A nor B was to change. Then the wide D's outputs
# (probs, logits, h sequences of numpy-seeded notes, velocity and
# instrument heads at H 512, B 256, f32 and bf16;
# midi_vae_tpu_torch/tools/time_d_and_m.py --only digests, the commit
# before D's other builds and M moved onto chains, from its git archive copy
# on the same card in one call): every D build now runs the wide D's chain,
# whose instances were not to change.
PARENT_DIGESTS = {
    "A xproj H256 f32": "daad80aebbbfcabd",
    "A chain seq H256 f32": "56be70eb18476de6",
    "A chain last H256 f32": "80f18c78e5c6c6a1",
    "C H256 f32": "94394c593067d95e",
    "C last H256 f32": "a3236d9a9a4d7b50",
    "A xproj H256 bf16": "e01775aab05c0ffd",
    "A chain seq H256 bf16": "d5c9506ca9ef7e2b",
    "A chain last H256 bf16": "9e781f3293e41b75",
    "C H256 bf16": "be76a42e52165ac8",
    "C last H256 bf16": "d6f0e3e942c2fafd",
    "A xproj H512 f32": "ac833d3f251359f5",
    "A chain seq H512 f32": "4487c385bd3ddf0b",
    "A chain last H512 f32": "311d0c38c3d6e3e8",
    "C H512 f32": "ef1028945439dcfa",
    "C last H512 f32": "e9bc175f253f8e4b",
    "A xproj H512 bf16": "edf5e25055392c82",
    "A chain seq H512 bf16": "4ac845f0b158bdff",
    "A chain last H512 bf16": "c42b766f47233bb5",
    "C H512 bf16": "ff3f7f227227602e",
    "C last H512 bf16": "4a265979565fc9e1",
    "E H256 f32": "afc079a7a089ae8e",
    "E H256 bf16": "5575b119a6137a8c",
    "E wide H512 f32": "6d16b5e806551b02",
    "E wide H512 bf16": "2d7faea2463e2359",
    "B chain notes H256": "9d72ad991e876c0b",
    "B chain velocity H256": "54ec7c11156d7178",
    "B chain instrument H256": "1f29c2741c0f2e40",
    "B chain notes H512": "29b6bea122835e3b",
    "B chain velocity H512": "9fb0c4809ee1eb7c",
    "B chain instrument H512": "9eb5435a77b36f49",
    "D wide notes H512 f32": "bad823b94781f4da",
    "D wide velocity H512 f32": "0ab45dd8d3f758b3",
    "D wide instrument H512 f32": "fa34040c2746be5f",
    "D wide notes H512 bf16": "ffeab8e93f452cc0",
    "D wide instrument H512 bf16": "018d3f07c6225d03"}


def phase_a_c_bits():
    """A's, B's, C's, E's and the wide D's outputs bit-equal to the parent
    commit's (``PARENT_DIGESTS``)."""
    from midi_vae_tpu_torch.tools import time_d_and_m, time_f_and_d

    got = {**time_f_and_d.digests(), **time_d_and_m.digests()}
    wrong = {k: (got.get(k), v) for k, v in PARENT_DIGESTS.items() if got.get(k) != v}
    if wrong or set(got) != set(PARENT_DIGESTS):
        raise RuntimeError(f"A's, B's, C's, E's or the wide D's outputs differ from the parent "
                           f"commit's (digest, parent digest): {wrong}")
    print(f"[bits] A's, B's, C's, E's and the wide D's outputs bit-equal to the parent commit's "
          f"({len(got)} digests)")
    return got


def phase_kernels():
    """Both kernels at the path's shapes, with the default model's weights."""
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.rnn import init_decoder_states
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.ops import gru_decode as gd
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
        results = {k: {} for k in ("gru_layer_fwd", "gru_decode", *A_PHASES)}
        for name, x, p, rs in layer_cases:
            args = (x, h0, p["w"], p["b"], p["u"], "tanh", rs)
            results["gru_layer_fwd"][name] = compare(
                f"A {name} x{tuple(x.shape)} rs={rs}",
                lambda a=args: gru_layer(*a), lambda a=args: gru_layer_reference(*a), [H_ATOL],
                inputs=args[:5], **a_work(x.shape[0], B, p["w"], p["u"]))
            for phase, res in a_phase_checks(compare, f"{name} rs={rs}", args, H_ATOL).items():
                results[phase][name] = res
            # a short song's bucket: fewer rows than a block's 8; one song's
            for rows in (RAGGED, 16):
                args = (x[:, :rows].contiguous(), h0[:rows], p["w"], p["b"], p["u"], "tanh", rs)
                check(f"A {name} B={rows}", lambda a=args: gru_layer(*a),
                      lambda a=args: gru_layer_reference(*a), [H_ATOL])
                a_phase_checks(check, f"{name} B={rows}", args, H_ATOL)
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
                [H_ATOL, LOGITS_ATOL], decode_flops(T, B, h["cells"], h["out"]["w"]), args[:4])
            # one song's bucket (one cluster's rows, or a few) and a ragged one
            for rows in (16, RAGGED):
                rargs = (args[0], args[1], [s[:rows] for s in states],
                         torch.zeros(rows, d, device=dev), T, "tanh", out_act)
                check(f"B {name} B={rows}", lambda a=rargs: gru_decode(*a),
                      lambda a=rargs: gru_decode_reference(*a), [H_ATOL, LOGITS_ATOL])
            # kernel D runs B's decode chain in its training instance: its
            # probs and logits bit-equal to B's chain at D's plan; its
            # per-block route keeps the body (gru_decode_body.cuh) of B's
            # first design: bit-equal to B's per-block route
            head = {"cells": list(h["cells"]), "out": h["out"], "init": states,
                    "start": torch.zeros(B, d, device=dev), "T": T, "out_activation": out_act}
            plan = gd.dec_plan(cfg.lstm_size, d, len(h["cells"]), B, T)
            pairs = {"chain": (gd.gru_decode_fwd_train([head], build="D")[0][:2],
                               gru_decode(*args, plan=plan)),
                     "per-block route": (d_block([head], "D")[0][:2], gd._decode_per_block(*args))}
            torch.cuda.synchronize()
            for route, ((dp, dl), (bp, bl)) in pairs.items():
                if not (torch.equal(dp, bp) and torch.equal(dl, bl)):
                    raise RuntimeError(f"kernel D's {route} on the {name} head is not bit-equal to "
                                       f"B's: max |diff| {(dp - bp).abs().max().item():.3e}")
        print(f"[kernels] every kernel call (and A's phases) also agrees at B = {RAGGED}; A and B "
              "at 16; D bit-equal to B on the three heads: its chain to B's chain at D's plan, its "
              "per-block route to B's per-block route")
    return results


def d_block(heads, build):
    """D's ``build`` on ``heads`` through its per-block route (8 rows a
    block, the wide builds 2; the route chooser told to take it)."""
    from midi_vae_tpu_torch.ops import gru_decode as gd

    saved = gd._layout.dec_train_route
    gd._layout.dec_train_route = lambda *_a: "block"
    try:
        fwd = gd.gru_decode_fwd_train_wide if build.startswith("D_wide") else gd.gru_decode_fwd_train
        return fwd(heads, build)
    finally:
        gd._layout.dec_train_route = saved


def _decode_train_heads(cfg, dec, new_encoded, rows, dev, wide=False):
    """The training decode calls of the default config as lists of head
    dicts (detached): the notes + velocity multi-head and the instrument
    head, or with ``wide`` each head on its own."""
    import torch

    from midi_vae_tpu_torch.models.rnn import init_decoder_states

    def head(name, d, T, out_act):
        h = dec[name]
        states = init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                     cfg.lstm_state_activation)
        return {"cells": [{k: c[k].detach() for k in "wub"} for c in h["cells"]],
                "out": {k: h["out"][k].detach() for k in "wb"},
                "init": [s[0].detach() for s in states], "start": torch.zeros(rows, d, device=dev),
                "T": T, "out_activation": out_act}

    notes = head("notes", cfg.output_dim, cfg.output_length, cfg.activation)
    velocity = head("velocity", 1, cfg.meta_velocity_length, cfg.meta_velocity_activation)
    instrument = head("instrument", cfg.meta_instrument_dim, cfg.meta_instrument_length,
                      cfg.meta_instrument_activation)
    if wide:
        return {"notes": [notes], "velocity": [velocity], "instrument": [instrument]}
    return {"multihead": [notes, velocity], "instrument": [instrument]}


def plain_weight_grads(x, hprev, rh, da):
    """dW, db, dU of one GRU cell through the plain version of W."""
    import torch

    from midi_vae_tpu_torch.ops.grad_reduce import grad_reduce_reference

    H = hprev.shape[-1]
    n = x.shape[0] * x.shape[1]
    da = da.reshape(n, 3 * H)
    dw, db = grad_reduce_reference(x.reshape(n, -1), da, True)
    return (dw, db, torch.cat([grad_reduce_reference(hprev.reshape(n, H), da[:, : 2 * H])[0],
                               grad_reduce_reference(rh.reshape(n, H), da[:, 2 * H :])[0]], 1))


def cublas_weight_grads(x, hprev, rh, da):
    """dW, db, dU of one GRU cell as PyTorch's ``a.t() @ b`` (cuBLAS): the
    library call W is timed against."""
    import torch

    H = hprev.shape[-1]
    n = x.shape[0] * x.shape[1]
    da = da.reshape(n, 3 * H)
    return (x.reshape(n, -1).t() @ da, da.sum(0),
            torch.cat([hprev.reshape(n, H).t() @ da[:, : 2 * H], rh.reshape(n, H).t() @ da[:, 2 * H :]], 1))


def weight_grad_flops(x, hprev):
    """Operations of W's dW and dU of one GRU cell, per row: x^T da (d_in x
    3H), h^T da_zr (H x 2H) and rh^T da_h (H x H) multiply-adds."""
    n, d_in, H = x.shape[0] * x.shape[1], x.shape[-1], hprev.shape[-1]
    return 2 * n * (d_in * 3 * H + 3 * H * H)


def check_decode_calls(calls, gen, run, timed, results, wide, block=True, best=False):
    """Kernel D and E (their wide builds when ``wide``) on each call's list of
    head dicts against their plain versions (D's per-block route too with
    ``block``), W over each head's products, and D + E + W against autograd
    through the plain decode; E's bounds at the card's best rates with
    ``best`` (e_work)."""
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops.grad_reduce import (
        grad_reduce,
        grad_reduce_reference,
        gru_weight_grads,
    )

    fwd = gd.gru_decode_fwd_train_wide if wide else gd.gru_decode_fwd_train
    bwd = gd.gru_decode_bwd_wide if wide else gd.gru_decode_bwd

    d_name, e_name = ("D wide", "E wide") if wide else ("D", "E")
    d_key, e_key, w_key = (("gru_decode_train_wide", "gru_decode_bwd_wide", "grad_reduce_wide")
                           if wide else ("gru_decode_train", "gru_decode_bwd", "grad_reduce"))
    dev = torch.device("cuda")
    rows = next(iter(calls.values()))[0]["start"].shape[0]
    for call, heads in calls.items():
        desc = " + ".join(f"{len(h['cells'])}L D={h['start'].shape[1]} T={h['T']} {h['out_activation']}"
                          for h in heads)
        limits = [lim for h in heads for lim in [H_ATOL, LOGITS_ATOL] + [H_ATOL] * len(h["cells"])]
        fwd_flat = lambda outs: tuple(t for p, l, hs in outs for t in (p, l, *hs))  # noqa: E731
        work = d_work(heads)
        plain_d = lambda h=heads: fwd_flat([gd.gru_decode_train_reference(  # noqa: E731
            x["cells"], x["out"], x["init"], x["start"], x["T"], x["out_activation"]) for x in h])
        out = run(f"{d_name} {call} ({desc})", lambda h=heads: fwd_flat(fwd(h)), plain_d, limits,
                  **work, inputs=[[h["cells"], h["out"], h["init"], h["start"]] for h in heads])
        if timed:
            results[d_key][call] = out
        # the chain (every head of these calls takes it) and the per-block
        # route, the first design, on the same heads
        if timed:
            results[d_key + "_chain"][call] = out
        if block:
            blk = run(f"{d_name} per-block route {call}", lambda h=heads: fwd_flat(
                d_block(h, "D_wide" if wide else "D")), plain_d, limits, **work,
                inputs=[[h["cells"], h["out"], h["init"], h["start"]] for h in heads])
            if timed:
                results[d_key + "_block"][call] = blk
        with torch.no_grad():
            for h in heads:
                h["probs"], _l, h["h_seqs"] = gd.gru_decode_train_reference(
                    h["cells"], h["out"], h["init"], h["start"], h["T"], h["out_activation"])
                h["g_probs"] = torch.randn(h["probs"].shape, generator=gen, device=dev)
                h["g_logits"] = torch.randn(h["probs"].shape, generator=gen, device=dev)
        bwd_flat = lambda outs: tuple(t for o in outs for t in (  # noqa: E731
            o["dlogits"], *o["da"], *o["rh"], *o["d_init"], o["d_start"]))
        limits = [lim for h in heads for lim in
                  [rel] + [rel] * len(h["cells"]) + [H_ATOL] * len(h["cells"])
                  + [rel] * len(h["cells"]) + [rel]]
        out = run(f"{e_name} {call}", lambda h=heads: bwd_flat(bwd(h)),
                  lambda h=heads: bwd_flat([gd.gru_decode_bwd_reference(
                      x["cells"], x["out"], x["init"], x["start"], x["probs"], x["h_seqs"],
                      x["g_probs"], x["g_logits"], x["out_activation"]) for x in h]), limits,
                  **e_work(heads, best=best), inputs=[[h[k] for k in ("cells", "out", "init", "start", "probs", "h_seqs",
                                          "g_probs", "g_logits")] for h in heads])
        if timed:
            results[e_key][call] = out
        for phase, res in e_phase_checks(run, f"{call} B={rows}", heads,
                                         "E_wide" if wide else "E", best).items():
            if timed:
                results[phase + ("_wide" if wide else "")][call] = res
        # W over one head's products: dWo, dbo and each cell's dW, db, dU
        for k, h in enumerate(heads):
            g = gd.gru_decode_bwd_reference(h["cells"], h["out"], h["init"], h["start"], h["probs"],
                                            h["h_seqs"], h["g_probs"], h["g_logits"], h["out_activation"])
            n, H, D = h["T"] * rows, h["init"][0].shape[1], h["start"].shape[1]
            top, dl = h["h_seqs"][-1].reshape(n, H), g["dlogits"].reshape(n, D)
            wsets = [(top, dl, None, None)] + [
                (h["h_seqs"][i - 1] if i else torch.cat([h["start"][None], h["probs"][:-1]]),
                 torch.cat([h["init"][i][None], h["h_seqs"][i][:-1]]), g["rh"][i], g["da"][i])
                for i in range(len(h["cells"]))]

            def kernel_w(ws=wsets):
                a, d, _, _ = ws[0]
                dwo = torch.empty(a.shape[1], d.shape[1], device=dev)
                dbo = torch.empty(d.shape[1], device=dev)
                grad_reduce(a, d, dwo, dbo)
                return (dwo, dbo, *(t for x, hp, rh, da in ws[1:]
                                    for t in gru_weight_grads(x, hp, rh, da)))

            def plain_w(ws=wsets):
                a, d, _, _ = ws[0]
                return (*grad_reduce_reference(a, d, True),
                        *(t for x, hp, rh, da in ws[1:] for t in plain_weight_grads(x, hp, rh, da)))

            def library_w(ws=wsets):
                a, d, _, _ = ws[0]
                return (a.t() @ d, d.sum(0), *(t for x, hp, rh, da in ws[1:]
                                               for t in cublas_weight_grads(x, hp, rh, da)))

            nw = 2 + 3 * len(h["cells"])
            out = run(f"W {call} head {k}", kernel_w, plain_w, [rel] * nw,
                      **tf32_work(2 * n * H * D + sum(weight_grad_flops(x, hp)
                                                      for x, hp, _, _ in wsets[1:])),
                      inputs=wsets, library_fn=library_w)
            if timed:
                results[w_key][f"decode {call} head {k}"] = out
        # D + E + W against autograd through the plain decode
        leaves = [[t.clone().requires_grad_() for t in gd._flatten_head(h)] for h in heads]
        lheads = [dict(h, **gd._unflatten_heads([(len(h["cells"]), h["out_activation"], h["T"])],
                                                 lv)[0]) for h, lv in zip(heads, leaves)]
        wanted = [t for lv in leaves for t in lv]

        def functional(outs):
            return sum((p * h["g_probs"]).sum() + (lg * h["g_logits"]).sum()
                       for (p, lg), h in zip(outs, heads))

        got = torch.autograd.grad(functional(gd._decode_heads_train(
            lheads, ("D_wide", "E_wide") if wide else None)), wanted)
        want = torch.autograd.grad(functional([gd.gru_decode_train_reference(
            h["cells"], h["out"], h["init"], h["start"], h["T"], h["out_activation"])[:2]
            for h in lheads]), wanted)
        check(f"{d_name}+{e_name}+W grads {call} B={rows}", lambda: got, lambda: want, [rel] * len(want))


def dwide_tc_checks(heads, h_limit, logits_limit):
    """The wide D's tensor-core instance (``csrc/gru_decode_chain.cuh``,
    which no path takes: it lost to the FFMA chain at every path head, PERF.md
    Findings) on ``heads``, each at its rule's plan, against the plain
    version: probs and the h sequences within ``h_limit``, logits within
    ``logits_limit``."""
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd

    picked = gd.dec_plan
    for h in heads:
        D, n, rows = h["start"].shape[1], len(h["cells"]), h["start"].shape[0]
        bf16 = h["start"].dtype == torch.bfloat16
        plan = gd._layout.dec_train_plan(512, D, n, rows, h["T"], bf16, tc=True)
        gd.dec_plan = lambda *_a, _p=plan: _p
        try:
            check(f"D wide tensor-core instance {n}L D={D} T={h['T']} B={rows}"
                  f"{' bf16' if bf16 else ''} (cluster {plan.cluster} x {plan.rows} rows)",
                  lambda h_=h: tuple(t for p, l, hs in gd.gru_decode_fwd_train_wide([h_])
                                     for t in (p, l, *hs)),
                  lambda h_=h: tuple(t for p, l, hs in [gd.gru_decode_train_reference(
                      h_["cells"], h_["out"], h_["init"], h_["start"], h_["T"],
                      h_["out_activation"])] for t in (p, l, *hs)),
                  [h_limit, logits_limit] + [h_limit] * n)
        finally:
            gd.dec_plan = picked


def c_phase_checks(run, tag, cargs):
    """C's phases (csrc/gru_cell_bwd_chain.cuh) on the inputs ``cargs`` of
    gru_layer_bwd, each against its plain version on the same inputs: the
    gate pre-pass (gates and r * h from x and hprev = [h0, seq[:-1]]), the
    chain over the plain pre-pass's gates, the dx pass over the plain
    chain's gate grads where the layer's dx is wanted. ``run`` is compare
    (timed, with bounds: ``c_work``) or check. Returns {counter name:
    result}."""
    import torch

    from midi_vae_tpu_torch.ops import gru_layer as gl

    x, seq, h0, d_seq, d_final, w, b, u, need_dx = cargs
    bf16 = x.dtype == torch.bfloat16
    sfx, kind = ("_bf16", "C bf16") if bf16 else ("", "C")
    out_lim = BF16_OUT if bf16 else rel
    hprev = torch.cat([h0[None], seq[:-1]])
    gargs = (x, hprev, w, b, u)
    found = {"gru_layer_bwd_gates" + sfx: run(
        f"{kind} gate pre-pass {tag}", lambda: gl.gru_layer_bwd_gates(*gargs),
        lambda: gl.gru_bwd_gates_reference(*gargs), [H_ATOL, H_ATOL],
        **c_work(x, u, need_dx, "gates"), inputs=gargs)}
    with torch.no_grad():
        gates = gl.gru_bwd_gates_reference(*gargs)[0]
    chargs = (gates, hprev, d_seq, d_final, u)
    found["gru_layer_bwd_chain" + sfx] = run(
        f"{kind} chain {tag}", lambda: gl.gru_layer_bwd_chain(*chargs),
        lambda: tuple(t if i == 0 else t.to(x.dtype)
                      for i, t in enumerate(gl.gru_bwd_chain_reference(*chargs))),
        [rel, out_lim], **c_work(x, u, need_dx, "chain"),
        inputs=[t for t in chargs if t is not None])
    if need_dx:
        with torch.no_grad():
            da = gl.gru_bwd_chain_reference(*chargs)[0]
        found["gru_layer_bwd_dx" + sfx] = run(
            f"{kind} dx pass {tag}", lambda: gl.gru_layer_bwd_dx(da, w),
            lambda: gl.gru_bwd_dx_reference(da, w), [out_lim],
            **c_work(x, u, need_dx, "dx"), inputs=(da, w),
            library_fn=None if bf16 else (lambda: da @ w.t()))
    return found


def g_phase_checks(run, tag, gargs, block=False):
    """G's phases (C's chain in csrc/gru_layer_xp_bwd.cu) on the inputs
    ``gargs`` of gru_layer_xp_bwd (xp, seq, h0, d_seq, d_final, u), each
    against its plain version on the same inputs: the xp gate pre-pass
    (gates and r * h from xp and hprev = [h0, seq[:-1]]), the chain over the
    plain pre-pass's gates (dxp, dh0, the float32 gate grads), and with
    ``block`` G's per-block route on the layer (its first design, the
    parent's). ``run`` is compare (timed, with bounds: ``g_work``; the
    per-block route's is the whole op's) or check. Returns {counter name:
    result}."""
    import torch

    from midi_vae_tpu_torch.ops import gru_layer as gl

    xp, seq, h0, d_seq, d_final, u = gargs
    bf16 = xp.dtype == torch.bfloat16
    sfx, kind = ("_bf16", "G bf16") if bf16 else ("", "G")
    out_lim = BF16_OUT if bf16 else rel
    hprev = torch.cat([h0[None], seq[:-1]])
    found = {"gru_layer_xp_bwd_gates" + sfx: run(
        f"{kind} xp gate pre-pass {tag}", lambda: gl.gru_layer_xp_bwd_gates(xp, hprev, u),
        lambda: gl.gru_bwd_gates_xp_reference(xp, hprev, u), [H_ATOL, H_ATOL],
        **g_work(xp, u, "gates"), inputs=(xp, hprev, u))}
    with torch.no_grad():
        gates = gl.gru_bwd_gates_xp_reference(xp, hprev, u)[0]
    chargs = (gates, hprev, d_seq, d_final, u)

    def plain_chain():
        da, dh0 = gl.gru_bwd_chain_reference(*chargs)
        return da.to(xp.dtype), dh0.to(xp.dtype), da

    found["gru_layer_xp_bwd_chain" + sfx] = run(
        f"{kind} chain {tag}", lambda: gl.gru_layer_xp_bwd_chain(*chargs), plain_chain,
        [out_lim, out_lim, rel], **g_work(xp, u, "chain"),
        inputs=[t for t in chargs if t is not None])
    if block:
        found["gru_layer_xp_bwd_block" + sfx] = run(
            f"{kind} per-block route {tag}", lambda: gl.gru_layer_xp_bwd_block(*gargs),
            lambda: gl.gru_layer_xp_bwd_reference(*gargs), [out_lim, out_lim, rel, H_ATOL],
            **g_work(xp, u), inputs=[t for t in gargs if t is not None])
    return found


def e_phase_checks(run, tag, heads, build, best=False):
    """E's phases on a call's heads (the dicts of gru_decode_bwd, with their
    forward's probs, h sequences and incoming grads) through ``build``, each
    against its plain version on the same inputs: the gate pre-pass of every
    layer, and the chain through the heads over the plain pre-pass's gates
    (dlogits and the gate grads rounded as ``build`` rounds them: E wide's
    streams hold bf16 values in bf16). Bounds: ``e_work`` (``best``: at the
    card's best rates). Returns {counter name: result}."""
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops import gru_layer as gl

    bf16 = heads[0]["start"].dtype == torch.bfloat16
    sfx = "_bf16" if bf16 else ""
    wide = build in ("E_wide", "E_wide_bf16")
    inputs = [gd._layer_inputs(h) for h in heads]

    def plain_gates():
        return [[gl.gru_bwd_gates_reference(x, hp, c["w"], c["b"], c["u"])
                 for (x, hp), c in zip(ins, h["cells"])] for h, ins in zip(heads, inputs)]

    flat_g = lambda gs: tuple(t for hg in gs for pair in hg for t in pair)  # noqa: E731
    found = {"gru_decode_bwd_gates" + sfx: run(
        f"E gate pre-pass {tag}", lambda: flat_g(gd.gru_decode_bwd_gates(heads, inputs)),
        lambda: flat_g(plain_gates()), [H_ATOL] * (2 * sum(len(h["cells"]) for h in heads)),
        **e_work(heads, "gates", best), inputs=[[h["cells"], h["start"], h["probs"], h["h_seqs"], h["init"]]
                        for h in heads])}
    with torch.no_grad():
        gates = plain_gates()
    hprevs = [[hp for _x, hp in ins] for ins in inputs]
    flat_c = lambda outs: tuple(t for o in outs for t in (  # noqa: E731
        o["dlogits"], *o["da"], *o["d_init"], o["d_start"]))
    # E wide bf16's streams hold bf16 values: a flip where the float sums
    # straddle a bf16 boundary; the other builds' are float32 sums
    stream = (bf16_step_lim, STREAM_REL_L2) if build == "E_wide_bf16" else rel
    limits = [lim for h in heads for lim in [stream] * (1 + len(h["cells"]))
              + [BF16_OUT if bf16 else rel] * (1 + len(h["cells"]))]
    found["gru_decode_bwd_chain" + sfx] = run(
        f"E chain {tag} ({build})",
        lambda: flat_c(gd.gru_decode_bwd_chain(heads, gates, build, hprevs)),
        lambda: flat_c([gd.gru_decode_bwd_chain_reference(h, [g for g, _rh in gs], hps, wide)
                        for h, gs, hps in zip(heads, gates, hprevs)]),
        limits, **e_work(heads, "chain", best),
        inputs=[[gates, hprevs], [[h[k] for k in ("cells", "out", "probs", "g_probs", "g_logits")]
                                  for h in heads]])
    return found


def phase_train_kernels():
    """Kernels C, D, E and W at the training path's shapes (B = 256: the four
    encoder layers, the notes + velocity multi-head, the instrument head) and
    again at B = 5, each against its plain version, plus the gradients of the
    training ops (A + C + W, D + E + W) against autograd through the plain
    forward."""
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.ops import gru_layer as gl
    from midi_vae_tpu_torch.ops.grad_reduce import gru_weight_grads

    cfg = Config()
    dev = torch.device("cuda")
    model = MidiVAE(cfg).to(dev)
    enc, dec = model.params["encoder"], model.params["decoder"]
    gen = torch.Generator(device=dev).manual_seed(0)
    tm = lambda a: a.transpose(0, 1).contiguous()  # noqa: E731
    results = {k: {} for k in ("gru_layer_bwd", "gru_decode_train", "gru_decode_train_chain",
                                "gru_decode_train_block", "gru_decode_bwd", "grad_reduce",
                                *C_PHASES, *E_PHASES)}
    flat = lambda outs: [t for t in outs if t is not None]  # noqa: E731

    for rows in (B, RAGGED):
        timed = rows == B
        run = compare if timed else check
        batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, rows, 3).items()}
        h0 = torch.zeros(rows, cfg.lstm_size, device=dev)
        p1 = [enc["notes_rnn"][0][k].detach() for k in "wbu"]
        with torch.no_grad():
            x_l2 = gl.gru_layer_reference(tm(batch["X"]), h0, *p1, "tanh", True)
        layer_cases = [  # name, x, params, return_sequences, dx wanted
            ("notes_l1", tm(batch["X"]), enc["notes_rnn"][0], True, False),
            ("notes_l2", x_l2, enc["notes_rnn"][1], False, True),
            ("instrument", tm(batch["I"]), enc["inst_rnn"][0], False, False),
            ("velocity", tm(batch["V"]), enc["vel_rnn"][0], False, False),
        ]
        for name, x, p, rs, need_dx in layer_cases:
            w, b, u = (p[k].detach() for k in "wbu")
            with torch.no_grad():
                seq = gl.gru_layer_reference(x, h0, w, b, u, "tanh", True)
            g = torch.randn(seq.shape if rs else seq.shape[1:], generator=gen, device=dev)
            args = (x, seq, h0, g if rs else None, None if rs else g, w, b, u, need_dx)
            # dx, dh0, da_cat: gradients; r*h a forward value
            limits = ([rel] if need_dx else []) + [rel, rel, H_ATOL]
            tag = f"C {name} x{tuple(x.shape)} rs={rs}"
            out = run(tag, lambda a=args: tuple(flat(gl.gru_layer_bwd(*a))),
                      lambda a=args: tuple(flat(gl.gru_layer_bwd_reference(*a))), limits,
                      **c_work(x, u, need_dx), inputs=args[:8])
            if timed:
                results["gru_layer_bwd"][name] = out
            for phase, res in c_phase_checks(run, f"{name} rs={rs} B={rows}", args).items():
                if timed:
                    results[phase][name] = res
            _dx, _dh0, da, rh = gl.gru_layer_bwd_reference(*args)
            wargs = (x, torch.cat([h0[None], seq[:-1]]), rh, da)
            out = run(f"W {name} dW, db, dU", lambda a=wargs: gru_weight_grads(*a),
                      lambda a=wargs: plain_weight_grads(*a), [rel] * 3,
                      **tf32_work(weight_grad_flops(x, wargs[1])), inputs=wargs,
                      library_fn=lambda a=wargs: cublas_weight_grads(*a))
            if timed:
                results["grad_reduce"][f"encoder {name}"] = out
            # A + C + W against autograd through the plain forward
            leaves = [t.clone().requires_grad_(i > 0 or need_dx) for i, t in enumerate((x, h0, w, b, u))]
            wanted = [t for t in leaves if t.requires_grad]
            got = torch.autograd.grad(gl.gru_layer_train_x(*leaves, rs), wanted, g)
            want = torch.autograd.grad(gl.gru_layer_reference(*leaves, "tanh", rs), wanted, g)
            check(f"A+C+W grads {name} B={rows}", lambda: got, lambda: want, [rel] * len(want))

        with torch.no_grad():
            z = model.encode(batch)
        new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
        check_decode_calls(_decode_train_heads(cfg, dec, new_encoded, rows, dev), gen, run, timed,
                           results, wide=False)
    print(f"[kernels] C, D, E, W and the training ops' gradients also agree at B = {RAGGED}")
    return results


def phase_wide_kernels():
    """The wide route at the wide model's shapes (Config() with
    lstm_size=512): F and G over the four encoder layers' x-projections (xp =
    x @ W + b, as the model computes it), W for their dU, the wide builds of
    D and E on each decode head alone, at B = 256 (timed) and B = 5, each
    against its plain version, and F + G + W and D + E + W against autograd
    through the plain forward. Then F and G at a GRU(256) layer, and A and B
    at H = 512: the serving path of a wide run."""
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.rnn import init_decoder_states
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops import gru_layer as gl
    from midi_vae_tpu_torch.ops.grad_reduce import grad_reduce_reference, gru_u_grad

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tm = lambda a: a.transpose(0, 1).contiguous()  # noqa: E731
    results = {k: {} for k in ("gru_layer_xp_fwd", "gru_layer_xp_bwd", "gru_decode_train_wide",
                               "gru_decode_bwd_wide", "grad_reduce_wide", "xp_h256_fwd",
                               "xp_h256_bwd", "gru_layer_512", "gru_decode_512",
                               "gru_layer_xp_fwd_chain", "gru_layer_xp_fwd_block",
                               "xp_h256_fwd_chain", "xp_h256_fwd_block",
                               "gru_decode_train_wide_chain", "gru_decode_train_wide_block",
                               *(f"{k}_wide" for k in E_PHASES), *G_PHASES)}

    def plain_u(hprev, rh, da):
        n, H = hprev.shape[0] * hprev.shape[1], hprev.shape[-1]
        da = da.reshape(n, 3 * H)
        return torch.cat([grad_reduce_reference(hprev.reshape(n, H), da[:, : 2 * H])[0],
                          grad_reduce_reference(rh.reshape(n, H), da[:, 2 * H :])[0]], 1)

    def layer_checks(tag, x, p, rs, rows, run, fwd_key, bwd_key, w_key):
        """F, G, W (dU) and F + G + W against autograd on one layer."""
        w, b, u = (p[k].detach() for k in "wbu")
        T, H = x.shape[0], u.shape[0]
        h0 = torch.zeros(rows, H, device=dev)
        with torch.no_grad():
            xp = (x.reshape(T * rows, -1) @ w + b).reshape(T, rows, 3 * H)
            seq = gl.gru_layer_xp_reference(xp, h0, u)
        out = run(f"F {tag} xp{tuple(xp.shape)}", lambda: gl.gru_layer_xp(xp, h0, u),
                  lambda: gl.gru_layer_xp_reference(xp, h0, u), [H_ATOL],
                  **f_work(T, rows, H), inputs=[xp, h0, u])
        if fwd_key:
            results[fwd_key][tag] = out
        # F's chain (the route at these widths) and its per-block route on the
        # same layer
        blk = run(f"F per-block route {tag}", lambda: gl.gru_layer_xp_fwd_block(xp, h0, u),
                  lambda: gl.gru_layer_xp_reference(xp, h0, u), [H_ATOL],
                  **f_work(T, rows, H), inputs=[xp, h0, u])
        if fwd_key:
            results[f"{fwd_key}_chain"][tag] = out
            results[f"{fwd_key}_block"][tag] = blk
        g = torch.randn(seq.shape if rs else seq.shape[1:], generator=gen, device=dev)
        args = (xp, seq, h0, g if rs else None, None if rs else g, u)
        # dxp, dh0, da_cat (dxp itself in float32): gradients; r*h a forward value
        out = run(f"G {tag} rs={rs}", lambda: gl.gru_layer_xp_bwd(*args)[1:],
                  lambda: gl.gru_layer_xp_bwd_reference(*args)[1:], [rel, rel, H_ATOL],
                  **g_work(xp, u), inputs=[t for t in args if t is not None])
        if bwd_key:
            results[bwd_key][tag] = out
        # G's phases; the per-block route beside them on notes L1 (timed at H = 512)
        main_path = bwd_key == "gru_layer_xp_bwd"
        for phase, res in g_phase_checks(run if main_path else check, f"{tag} rs={rs}", args,
                                         block=tag == "notes_l1").items():
            if main_path:
                results[phase][tag] = res
        _dxp, _dh0, da, rh = gl.gru_layer_xp_bwd_reference(*args)
        hprev = torch.cat([h0[None], seq[:-1]])
        n = T * rows
        out = run(f"W {tag} dU", lambda: gru_u_grad(hprev, rh, da), lambda: plain_u(hprev, rh, da),
                  [rel], flops=2 * n * u.numel(), inputs=[hprev, rh, da],
                  library_fn=lambda: torch.cat([hprev.reshape(n, H).t() @ da.reshape(n, 3 * H)[:, : 2 * H],
                                                rh.reshape(n, H).t() @ da.reshape(n, 3 * H)[:, 2 * H :]], 1))
        if w_key:
            results[w_key][f"encoder {tag}"] = out
        leaves = [t.clone().requires_grad_() for t in (xp, h0, u)]
        got = torch.autograd.grad(gl.gru_layer_train(*leaves, rs), leaves, g)
        plain = gl.gru_layer_xp_reference(*leaves)
        want = torch.autograd.grad(plain if rs else plain[-1], leaves, g)
        check(f"F+G+W grads {tag} B={rows}", lambda: got, lambda: want, [rel] * 3)
        return seq

    for H in (512, 256):
        cfg = Config(lstm_size=H)
        model = MidiVAE(cfg).to(dev)
        enc, dec = model.params["encoder"], model.params["decoder"]
        for rows in (B, RAGGED):
            timed = rows == B
            run = compare if timed else check
            batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, rows, 6).items()}
            if H == 256:  # rows 9 and 10: F and G at a GRU(256) layer
                seq = layer_checks("h256 notes_l1", tm(batch["X"]), enc["notes_rnn"][0], True, rows,
                                   run, "xp_h256_fwd" if timed else None,
                                   "xp_h256_bwd" if timed else None, None)
                layer_checks("h256 notes_l2", seq, enc["notes_rnn"][1], False, rows, run,
                             "xp_h256_fwd" if timed else None, "xp_h256_bwd" if timed else None,
                             None)
                continue
            keys = ("gru_layer_xp_fwd", "gru_layer_xp_bwd", "grad_reduce_wide") if timed else (
                None, None, None)
            seq = layer_checks("notes_l1", tm(batch["X"]), enc["notes_rnn"][0], True, rows, run,
                               *keys)
            layer_checks("notes_l2", seq, enc["notes_rnn"][1], False, rows, run, *keys)
            layer_checks("instrument", tm(batch["I"]), enc["inst_rnn"][0], False, rows, run, *keys)
            layer_checks("velocity", tm(batch["V"]), enc["vel_rnn"][0], False, rows, run, *keys)
            with torch.no_grad():
                z = model.encode(batch)
            new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
            calls = _decode_train_heads(cfg, dec, new_encoded, rows, dev, wide=True)
            check_decode_calls(calls, gen, run, timed, results, wide=True)
            dwide_tc_checks([h for heads in calls.values() for h in heads], H_ATOL, LOGITS_ATOL)
            # the serving kernels at H = 512: A on the encoder layers, B on the heads
            with torch.inference_mode():
                h0 = torch.zeros(rows, H, device=dev)
                for name, x, p, rs in (("notes_l1", tm(batch["X"]), enc["notes_rnn"][0], True),
                                       ("notes_l2", seq, enc["notes_rnn"][1], False),
                                       ("instrument", tm(batch["I"]), enc["inst_rnn"][0], False),
                                       ("velocity", tm(batch["V"]), enc["vel_rnn"][0], False)):
                    args = (x, h0, p["w"], p["b"], p["u"], "tanh", rs)
                    out = run(f"A H={H} {name} rs={rs}", lambda a=args: gl.gru_layer(*a),
                              lambda a=args: gl.gru_layer_reference(*a), [H_ATOL],
                              **a_work(x.shape[0], rows, p["w"], p["u"]), inputs=args[:5])
                    if timed:
                        results["gru_layer_512"][name] = out
                for name, d, T, out_act in (
                        ("notes", cfg.output_dim, cfg.output_length, cfg.activation),
                        ("velocity", 1, cfg.meta_velocity_length, cfg.meta_velocity_activation),
                        ("instrument", cfg.meta_instrument_dim, cfg.meta_instrument_length,
                         cfg.meta_instrument_activation)):
                    h = dec[name]
                    states = [s[0] for s in init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                                                cfg.lstm_state_activation)]
                    args = (list(h["cells"]), h["out"], states, torch.zeros(rows, d, device=dev), T,
                            "tanh", out_act)
                    out = run(f"B H={H} {name}", lambda a=args: gd.gru_decode(*a),
                              lambda a=args: gd.gru_decode_reference(*a), [H_ATOL, LOGITS_ATOL],
                              flops=decode_flops(T, rows, h["cells"], h["out"]["w"]), inputs=args[:4])
                    if timed:  # one song's bucket too
                        sargs = (args[0], args[1], [st[:16] for st in states],
                                 torch.zeros(16, d, device=dev), T, "tanh", out_act)
                        check(f"B H={H} {name} B=16", lambda a=sargs: gd.gru_decode(*a),
                              lambda a=sargs: gd.gru_decode_reference(*a), [H_ATOL, LOGITS_ATOL])
                    if timed:
                        results["gru_decode_512"][name] = out
    g_block_widths()
    print(f"[wide kernels] F, G, the wide D and E, W, A and B at H = 512 and F, G at H = 256 also "
          f"agree at B = {RAGGED}")
    return results


def g_block_widths():
    """G's per-block route where the route chooser sends it (H = 96: C's
    chain takes H a multiple of 64), float32 and bf16, the sequence's grad
    and the final h's, against the plain version; and that the route ran
    (G's per-block counter moved, its chain's did not)."""
    import torch

    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import gru_layer as gl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(96)
    H, T = 96, 16
    assert _layout.gru_xp_bwd_route(H) == _layout.gru_xp_bwd_route(H, True) == "block"
    for dt in (torch.float32, torch.bfloat16):
        before = {fn: (fn.launches, fn.launches_bf16)
                  for fn in (gl.gru_layer_xp_bwd_block, gl.gru_layer_xp_bwd_chain)}
        lim = BF16_OUT if dt == torch.bfloat16 else rel
        for rows in (16, RAGGED):
            for rs in (True, False):
                randn = lambda *s_: torch.randn(*s_, generator=gen, device=dev)  # noqa: E731
                xp = randn(T, rows, 3 * H).to(dt)
                h0 = torch.tanh(randn(rows, H)).to(dt)
                u = (randn(H, 3 * H) / H ** 0.5).to(dt)
                seq = gl.gru_layer_xp_reference(xp, h0, u)
                g = randn(*(seq.shape if rs else seq.shape[1:])).to(dt)
                args = (xp, seq, h0, g if rs else None, None if rs else g, u)
                check(f"G per-block route H={H} {dt} B={rows} rs={rs}",
                      lambda a=args: gl.gru_layer_xp_bwd(*a),
                      lambda a=args: gl.gru_layer_xp_bwd_reference(*a),
                      [lim, lim, rel, H_ATOL])
        after = {fn: (fn.launches, fn.launches_bf16) for fn in before}
        i = int(dt == torch.bfloat16)
        if (after[gl.gru_layer_xp_bwd_block][i] - before[gl.gru_layer_xp_bwd_block][i] != 4
                or after[gl.gru_layer_xp_bwd_chain] != before[gl.gru_layer_xp_bwd_chain]):
            raise RuntimeError(f"G at H = {H} ({dt}) did not take its per-block route alone")
    print(f"[wide kernels] G's per-block route at H = {H} (f32, bf16) agrees with its plain "
          "version")


def cudnn_lstm(x, p, h0, c0):
    """cuDNN's LSTM (``torch.nn.LSTM``) holding one LSTM layer's weights:
    weight_ih = W^T, weight_hh = U^T, bias_ih = b, bias_hh = 0 computes the
    cell of kernel L (tanh, sigmoid gates, gate order i, f, g, o). The
    yardstick ``library_ms`` of L; the port never calls it."""
    import torch

    D, G = p["w"].shape
    lstm = torch.nn.LSTM(D, G // 4).to(x.device).requires_grad_(False)
    lstm.weight_ih_l0.copy_(p["w"].t())
    lstm.weight_hh_l0.copy_(p["u"].t())
    lstm.bias_ih_l0.copy_(p["b"])
    lstm.bias_hh_l0.zero_()
    return lambda: lstm(x, (h0[None], c0[None]))


def a_work(T, B, w, u, best=False):
    """compare()'s work of A's float32 build: x @ W as three TF32 products
    (the pre-pass on the tensor cores), the recurrent products at the
    float32 rate (the chain's FFMA); with ``best`` the recurrent products
    too as three TF32 products, as f_work prices F's."""
    if best:
        return tf32_work(layer_flops(T, B, w, u))
    return {"flops": 3 * 2 * T * B * w.numel(), "peak": PEAK_TF32_FLOPS,
            "flops_f32": 2 * T * B * u.numel()}


def t_work(rows, d_in, H, bf16=False):
    """compare()'s work of one launch of kernel T (d_in = 0: T xp): P1 =
    [x | h] . [W ; U_zr] (2 rows (d_in 3H + 2H^2) operations), P2 = (r h) .
    U_h (2 rows H^2), taken on the tensor cores: float32 three TF32 products
    each; bf16 P1 one product of bf16 operands, P2 two (r h float), at the
    bf16 rate."""
    p1, p2 = 2 * rows * (d_in * 3 * H + 2 * H * H), 2 * rows * H * H
    if bf16:
        return {"flops": p1 + 2 * p2, "peak": PEAK_BF16_FLOPS}
    return tf32_work(p1 + p2)


def tf32_work(flops, products=3):
    """compare()'s work of a product taken on the tensor cores as
    ``products`` TF32 products: W and L's pre-pass take a float32 product as
    three, a bf16 A's as two (W bf16's float32 sums over r * h counted as
    two too: a lower bound still)."""
    return {"flops": products * flops, "peak": PEAK_TF32_FLOPS}


def l_phase_checks(run, tag, args):
    """L's two phases (csrc/lstm_layer_fwd.cu) on the inputs ``args`` of
    ``lstm_layer`` (x, h0, c0, w, b, u, activation, return_sequences[,
    with_c]), each against its plain version: the pre-pass (xp = x @ W + b
    in float32; bound: three TF32 products in float32, one bf16 product in
    bf16; library: one torch.addmm in float32) and the chain over the plain
    pre-pass's xp (bound: h @ U at the FFMA rate in float32, at the bf16
    rate in bf16; library: cuDNN's LSTM over xp, w_ih = I, in float32 with
    tanh cells: its bf16 build would take xp rounded). Returns {counter
    name: result}."""
    import torch

    from midi_vae_tpu_torch.ops import lstm_layer as ll

    x, h0, c0, w, b, u, act, rs, *rest = args
    with_c = bool(rest and rest[0])
    T, rows, D = x.shape
    G, H = w.shape[1], u.shape[0]
    bf16 = x.dtype == torch.bfloat16
    sfx, kind = ("_bf16", "L bf16") if bf16 else ("", "L")
    timed = run is compare
    with torch.no_grad():
        xp = ll.lstm_xproj_reference(x, w, b)
    flops = 2 * T * rows * D * G
    found = {f"lstm_layer_xproj{sfx}": run(
        f"{kind} pre-pass {tag} x{tuple(x.shape)}", lambda: ll.lstm_layer_xproj(x, w, b),
        lambda: ll.lstm_xproj_reference(x, w, b), [L_H_ATOL],
        **({"flops": flops, "peak": PEAK_BF16_FLOPS} if bf16 else tf32_work(flops)),
        inputs=(x, w, b), library_fn=None if bf16 or not timed else (
            lambda: torch.addmm(b, x.reshape(T * rows, D), w)))}
    cargs = (xp, h0, c0, u, act, rs, with_c)
    n_out = 2 if with_c else 1
    limits = [BF16_OUT] * n_out if bf16 else [L_H_ATOL, C_ATOL][:n_out]
    flops = 2 * T * rows * H * G
    # cuDNN's forward over xp: weight_ih = I, bias_ih = 0 (forward only, so
    # that it runs under inference_mode too)
    library = (cudnn_lstm(xp, {"w": torch.eye(G, device=xp.device), "u": u,
                               "b": torch.zeros(G, device=xp.device)}, h0, c0)
               if timed and not bf16 and act == "tanh" else None)
    found[f"lstm_layer_fwd_chain{sfx}"] = run(
        f"{kind} chain {tag} xp{tuple(xp.shape)}", lambda: ll.lstm_layer_fwd_chain(*cargs),
        lambda: ll.lstm_fwd_chain_reference(*cargs), limits,
        **({"flops": flops, "peak": PEAK_BF16_FLOPS} if bf16 else
           {"flops": 0.0, "flops_f32": flops}),
        inputs=(xp, h0, c0, u), library_fn=library)
    return found


def a_phase_checks(run, tag, args, limit):
    """A's phases (csrc/gru_layer_fwd.cu) on the inputs ``args`` of
    ``gru_layer`` (x, h0, w, b, u, activation, return_sequences), each
    against its plain version: the pre-pass (xp = x @ W + b in float32;
    bound: three TF32 products in float32, one bf16 product in bf16;
    library: one torch.addmm in float32), the chain over the plain
    pre-pass's xp (bound: h @ U[:, :2H] at the FFMA rate in float32, at the
    bf16 rate in bf16, (r * h) @ U[:, 2H:] at the FFMA rate; no library: the
    GRU is reset-before) and A's per-block route on the layer (bound as A's:
    ``a_work``, ``layer_flops_bf16``),
    the chain and the route held to ``limit`` (A's). Returns {counter name:
    result}."""
    import torch

    from midi_vae_tpu_torch.ops import gru_layer as gl

    x, h0, w, b, u, act, rs = args
    T, rows, D = x.shape
    G, H = w.shape[1], u.shape[0]
    bf16 = x.dtype == torch.bfloat16
    sfx, kind = ("_bf16", "A bf16") if bf16 else ("", "A")
    timed = run is compare
    with torch.no_grad():
        xp = gl.gru_xproj_reference(x, w, b)
    flops = 2 * T * rows * D * G
    found = {f"gru_layer_xproj{sfx}": run(
        f"{kind} pre-pass {tag} x{tuple(x.shape)}", lambda: gl.gru_layer_xproj(x, w, b),
        lambda: gl.gru_xproj_reference(x, w, b), [L_H_ATOL],
        **({"flops": flops, "peak": PEAK_BF16_FLOPS} if bf16 else tf32_work(flops)),
        inputs=(x, w, b), library_fn=None if bf16 or not timed else (
            lambda: torch.addmm(b, x.reshape(T * rows, D), w)))}
    cargs = (xp, h0, u, act, rs)
    zr, cand = 2 * T * rows * H * 2 * H, 2 * T * rows * H * H
    found[f"gru_layer_fwd_chain{sfx}"] = run(
        f"{kind} chain {tag} xp{tuple(xp.shape)}", lambda: gl.gru_layer_fwd_chain(*cargs),
        lambda: gl.gru_fwd_chain_reference(*cargs), [limit],
        **({"flops": zr, "flops_f32": cand, "peak": PEAK_BF16_FLOPS} if bf16 else
           {"flops": 0.0, "flops_f32": zr + cand}),
        inputs=(xp, h0, u))
    fb, ff = layer_flops_bf16(T, rows, w, u) if bf16 else (0.0, 0.0)
    found[f"gru_layer_block{sfx}"] = run(
        f"{kind} block {tag} x{tuple(x.shape)}", lambda: gl.gru_layer_block(*args),
        lambda: gl.gru_layer_reference(*args), [limit], inputs=args[:5],
        **({"flops": fb, "flops_f32": ff, "peak": PEAK_BF16_FLOPS} if bf16
           else a_work(T, rows, w, u)))
    return found


def phase_lstm_kernels():
    """Kernels L and M against their plain versions at the LSTM transfer's
    shapes (Config(cell_type="LSTM"), LSTM(256) x 2: notes L1 and L2,
    instrument, velocity; the notes, velocity and instrument heads), at B =
    256 (timed, with the bound and, for L, cuDNN's LSTM beside it) and B = 5;
    L's two phases (the pre-pass, the chain) each against its plain version,
    and L's per-block route (which no path at these widths takes) on the
    same layers."""
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.rnn import init_decoder_states
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import lstm_decode as ld
    from midi_vae_tpu_torch.ops.lstm_decode import lstm_decode, lstm_decode_reference
    from midi_vae_tpu_torch.ops.lstm_layer import lstm_layer, lstm_layer_block, lstm_layer_reference

    def m_block(*args):
        """M's per-block route (the first design) on ``args`` (the route
        chooser told to take it)."""
        saved = _layout.lstm_decode_route
        _layout.lstm_decode_route = lambda *_a: "block"
        try:
            return lstm_decode(*args)
        finally:
            _layout.lstm_decode_route = saved

    cfg = Config(cell_type="LSTM")
    dev = torch.device("cuda")
    model = MidiVAE(cfg).to(dev)
    enc, dec = model.params["encoder"], model.params["decoder"]
    tm = lambda a: a.transpose(0, 1).contiguous()  # noqa: E731
    results = {k: {} for k in ("lstm_layer_fwd", "lstm_decode", "lstm_decode_chain",
                                "lstm_decode_block", *L_PHASES)}
    for rows in (B, RAGGED):
        timed = rows == B
        run = compare if timed else check
        batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, rows, 7).items()}
        h0 = torch.zeros(rows, cfg.lstm_size, device=dev)
        c0 = torch.zeros(rows, cfg.lstm_size, device=dev)
        with torch.inference_mode():
            x_l2 = lstm_layer_reference(tm(batch["X"]), h0, c0,
                                        *(enc["notes_rnn"][0][k] for k in "wbu"), "tanh", True)
            for name, x, p, rs in (("notes_l1", tm(batch["X"]), enc["notes_rnn"][0], True),
                                   ("notes_l2", x_l2, enc["notes_rnn"][1], False),
                                   ("instrument", tm(batch["I"]), enc["inst_rnn"][0], False),
                                   ("velocity", tm(batch["V"]), enc["vel_rnn"][0], False)):
                args = (x, h0, c0, p["w"], p["b"], p["u"], "tanh", rs)
                library = cudnn_lstm(x, p, h0, c0) if timed else None
                if timed:
                    seq, (h_n, _c_n) = library()
                    lib_err = ((seq if rs else h_n[0]) - lstm_layer_reference(*args)).abs().max().item()
                    print(f"[lstm kernels] cuDNN LSTM (the library yardstick) on {name}: max |diff| "
                          f"to the plain version {lib_err:.3e}")
                out = run(f"L {name} x{tuple(x.shape)} rs={rs}", lambda a=args: lstm_layer(*a),
                          lambda a=args: lstm_layer_reference(*a), [L_H_ATOL],
                          flops=layer_flops(x.shape[0], rows, p["w"], p["u"]), inputs=args[:6],
                          library_fn=library)
                if timed:
                    results["lstm_layer_fwd"][name] = out
                for phase, res in l_phase_checks(run, f"{name} rs={rs}", args).items():
                    if timed:
                        results[phase][name] = res
                out = run(f"L block {name} x{tuple(x.shape)} rs={rs}",
                          lambda a=args: lstm_layer_block(*a),
                          lambda a=args: lstm_layer_reference(*a), [L_H_ATOL],
                          flops=layer_flops(x.shape[0], rows, p["w"], p["u"]), inputs=args[:6])
                if timed:
                    results["lstm_layer_block"][name] = out
            z = model.encode(batch)
            new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
            for name, d, T, out_act in (
                    ("notes", cfg.output_dim, cfg.output_length, cfg.activation),
                    ("velocity", 1, cfg.meta_velocity_length, cfg.meta_velocity_activation),
                    ("instrument", cfg.meta_instrument_dim, cfg.meta_instrument_length,
                     cfg.meta_instrument_activation)):
                h = dec[name]
                states = init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                             cfg.lstm_state_activation)
                args = (list(h["cells"]), h["out"], states, torch.zeros(rows, d, device=dev), T,
                        "tanh", out_act)
                # f32 x f32 products priced as three TF32 products
                work = tf32_work(decode_flops(T, rows, h["cells"], h["out"]["w"]))
                tag = f"{name} layers={len(h['cells'])} D={d} T={T} {out_act}"
                out = run(f"M {tag}", lambda a=args: lstm_decode(*a),
                          lambda a=args: lstm_decode_reference(*a), [M_PROBS_ATOL, LOGITS_ATOL],
                          **work, inputs=args[:4])
                # the per-block route (the first design) on the same head, and
                # the chain's other build (the other count of h tiles a layer)
                blk = run(f"M per-block route {tag}", lambda a=args: m_block(*a),
                          lambda a=args: lstm_decode_reference(*a), [M_PROBS_ATOL, LOGITS_ATOL],
                          **work, inputs=args[:4])
                picked = ld.decode_plan(cfg.lstm_size, d, len(h["cells"]), rows, T)
                other = _layout.lstm_decode_plan(cfg.lstm_size, d, len(h["cells"]), rows, T=T,
                                                 nb=3 - picked.nb)
                check(f"M chain {tag} B={rows} with {other.nb} h tiles a layer "
                      f"(cluster {other.cluster} x {other.rows} rows)",
                      lambda a=args, p_=other: ld.lstm_decode(*a, plan=p_),
                      lambda a=args: lstm_decode_reference(*a), [M_PROBS_ATOL, LOGITS_ATOL])
                if name == "notes":
                    got, want = lstm_decode(*args)[0], lstm_decode_reference(*args)[0]
                    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
                    if agree < MIN_ARGMAX_AGREEMENT:
                        raise RuntimeError(f"M notes B={rows}: argmax agreement {agree:.5f} < "
                                           f"{MIN_ARGMAX_AGREEMENT}")
                if timed:
                    results["lstm_decode"][name] = out
                    results["lstm_decode_chain"][name] = out
                    results["lstm_decode_block"][name] = blk
    print(f"[lstm kernels] L (its phases, its per-block route) and M (its chain, both counts of h "
          f"tiles, its per-block route) also agree at B = {RAGGED}")
    return results


# the serving kernels of each cell type: (encoder layer, decode head)
SERVING_KERNELS = {"GRU": ("gru_layer_fwd", "gru_decode"), "LSTM": ("lstm_layer_fwd", "lstm_decode")}


def write_judges(judge_dir, cfg):
    """Judges of all three kinds for ``cfg``'s cell type, at the reference
    width (RNN(256) x 2), from seeded inits, in the port's judge format."""
    from midi_vae_tpu_torch import bridge
    from midi_vae_tpu_torch.models.classifier import CLASSIFIER_KINDS, ClassifierSpec, StyleClassifier
    from midi_vae_tpu_torch.training.checkpoint import save_classifier

    for seed, kind in enumerate(CLASSIFIER_KINDS):
        spec = ClassifierSpec.for_kind(kind, cfg)
        save_classifier(os.path.join(judge_dir, kind), spec,
                        bridge.to_tree(StyleClassifier(spec, seed=seed).params))


def phase_slice(work, cell_type="GRU", judges=False):
    """The transfer CLI at full width (``Config(cell_type=...)``) on 3
    authored songs, on the card, with --write-reconstruction and, with
    ``judges``, --classifiers (judges of all three kinds)."""
    import io
    from contextlib import redirect_stdout

    import numpy as np

    from midi_vae_tpu_torch import bridge
    from midi_vae_tpu_torch.cli import transfer
    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.data import smf
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.training.checkpoint import save_run

    from midi_vae_tpu_torch.tools import make_demo_corpus as corpus

    cfg = Config(cell_type=cell_type)
    tag = f"{cell_type}{' + judges' if judges else ''}"
    work = os.path.join(work, f"{cell_type.lower()}_{int(judges)}")
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
    args = ["--model", run, "--input", *inputs, "--to-class", "style2", "--output", out,
            "--device", "cuda", "--write-reconstruction"]
    if judges:
        write_judges(os.path.join(work, "judges"), cfg)
        args += ["--classifiers", os.path.join(work, "judges")]

    reset_counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = transfer.main(args)
    secs = time.perf_counter() - t0
    launches = read_counters()
    print("\n".join(f"[slice {tag}] {line}" for line in buf.getvalue().splitlines()))
    if rc != 0:
        raise RuntimeError(f"transfer CLI ({tag}) returned {rc}")
    written = sorted(os.listdir(out))
    expected = sorted([f"song{i}_style1_to_style2.mid" for i in range(3)]
                      + [f"song{i}_reconstruction.mid" for i in range(3)])
    if written != expected:
        raise RuntimeError(f"transfer ({tag}) wrote {written}, expected {expected}")
    for name in written:
        mid = smf.read_midi(os.path.join(out, name))
        if not mid.instruments or not any(inst.notes for inst in mid.instruments):
            raise RuntimeError(f"{name} ({tag}) parsed back with no notes")
    judged = [line for line in buf.getvalue().splitlines() if "judge confidence" in line]
    if judges and len(judged) != 2 * len(inputs):
        raise RuntimeError(f"transfer ({tag}) printed {len(judged)} judge lines, expected "
                           f"{2 * len(inputs)}")
    # per song: transfer (encode 4 layers, decode 3 heads) + reconstruction
    # (encode_song 4 layers, decode_and_process 3 heads); with the judges 2
    # layers per judge call, 3 calls (pitch, velocity, instrument) for the
    # original and 3 for the transferred song
    layer, decode = SERVING_KERNELS[cell_type]
    want = fwd_phases({layer: (8 + (2 * 6 if judges else 0)) * len(inputs), decode: 6 * len(inputs)})
    if launches != want:
        raise RuntimeError(f"transfer ({tag}): launch counters {launches}, expected {want}")
    print(f"[slice {tag}] transfer CLI on {len(inputs)} songs in {secs:.2f} s (build done); wrote "
          f"{len(written)} .mid files that parse back; launches {launches}")
    return launches


# launches per call of the default Config() on the training path, per route
# (ops/_layout.py): the four encoder layers (notes x 2, instrument, velocity)
# and the decode calls; W reduces per GRU cell 3 products on the narrow route
# (dW, db with dU[:, :2H]; dU[:, 2H:]) and 2 on the wide one (dU only: dW and
# db are autograd over xp = x @ W + b), and 1 per head's output dense. An
# LSTM step (Config(cell_type="LSTM")) runs S once per head cell and decode
# step (notes 2 x 64, velocity 64, instrument 4: 196), whose backward is the
# plain version's, so W reduces only the encoder layers: dW with db, and dU
# (2 per layer) on the narrow route, dU (1) on the wide one
S_PER_STEP = 2 * 64 + 64 + 4
PER_TRAIN_STEP = {
    # A + C per layer; notes + velocity multi-head and the instrument head
    # (D: one launch a head, E one a call); W: 3 x (4 encoder + 2 notes + 1
    # velocity + 1 instrument cells) + 3
    "narrow": {"gru_layer_fwd": 4, "gru_layer_bwd": 4, "gru_decode_train": 3,
               "gru_decode_bwd": 2, "grad_reduce": 27},
    # F + G per layer; each head alone; W: 2 x 4 + 3 x 4 decode cells + 3
    "wide": {"gru_layer_xp_fwd": 4, "gru_layer_xp_bwd": 4, "gru_decode_train_wide": 3,
             "gru_decode_bwd_wide": 3, "grad_reduce": 23},
    # N's and R's phases: the pre-pass and the chain per layer, N's dx pass
    # for notes layer 2 alone (the other layers' inputs are the batch)
    "lstm_narrow": {"lstm_layer_fwd": 4, "lstm_layer_bwd": 4, "lstm_layer_bwd_gates": 4,
                    "lstm_layer_bwd_chain": 4, "lstm_layer_bwd_dx": 1, "lstm_step": S_PER_STEP,
                    "grad_reduce": 8},
    "lstm_wide": {"lstm_layer_xp_fwd": 4, "lstm_layer_xp_bwd": 4, "lstm_layer_xp_bwd_gates": 4,
                  "lstm_layer_xp_bwd_chain": 4, "lstm_step": S_PER_STEP, "grad_reduce": 4},
    # the per-step configs (their backward through the cells is the plain
    # versions'): merge_decoder_scans runs the notes and velocity heads
    # through T (2 x 64 + 64), the instrument head through D and E (W 3 + 1);
    # no_fused_train the four encoder layers through T xp (64 + 64 + 4 + 64)
    # and every head through T; the LSTM with fused_train_encoder=False the
    # layers through S xp and the heads through S; no W where nothing but
    # the per-step cells runs (dW, db of xp = x @ W + b by autograd)
    "merge": {"gru_layer_fwd": 4, "gru_layer_bwd": 4, "gru_step": 2 * 64 + 64,
              "gru_decode_train": 1, "gru_decode_bwd": 1, "grad_reduce": 16},
    "no_fused_train": {"gru_step_xp": S_PER_STEP, "gru_step": S_PER_STEP},
    "lstm_no_fused_encoder": {"lstm_step_xp": S_PER_STEP, "lstm_step": S_PER_STEP},
    # bf16 with fused_train_encoder=False: the four encoder layers through
    # the whole-scan kernel X or Y, every head cell through T's or S's bf16
    # build (their backward: the plain versions)
    "bf16_no_fused_train": {"gru_encoder_scan": 4, "gru_step_bf16": S_PER_STEP},
    "lstm_bf16_no_fused_encoder": {"lstm_encoder_scan": 4, "lstm_step_bf16": S_PER_STEP},
    # bf16 with the default flags: A + C in bf16 per encoder layer; each head
    # decoded alone (the multi-head call is float32 only): notes and
    # instrument through D and E in bf16, velocity (D = 1 < 8) promoted to
    # float32; W over bf16 activations for dW and dU[:, :2H] of the 4 encoder
    # and 2 + 1 bf16 head cells and the 2 bf16 heads' dWo (16), over float32
    # operands for dU[:, 2H:] (r * h) of every cell (8) and the velocity
    # head's dW, dU[:, :2H] and dWo (3)
    "bf16": {"gru_layer_fwd_bf16": 4, "gru_layer_bwd_bf16": 4, "gru_decode_train_bf16": 2,
             "gru_decode_train": 1, "gru_decode_bwd_bf16": 2, "gru_decode_bwd": 1,
             "grad_reduce_bf16": 16, "grad_reduce": 11},
    # merge_decoder_scans in bf16: notes and velocity through T's bf16 build
    # (2 x 64 + 64), the instrument head through D and E in bf16; W: 8 + 3
    # over bf16 activations, 4 + 1 over r * h
    "merge_bf16": {"gru_layer_fwd_bf16": 4, "gru_layer_bwd_bf16": 4, "gru_step_bf16": 2 * 64 + 64,
                   "gru_decode_train_bf16": 1, "gru_decode_bwd_bf16": 1, "grad_reduce_bf16": 11,
                   "grad_reduce": 5},
    # bf16 on the wide route (lstm_size=512): each encoder layer's forward
    # through kernel X (row 9 in bf16), its backward through G's bf16 build;
    # the notes and instrument heads through the wide D and E's bf16 builds,
    # velocity (D = 1 < 8) through their float32 builds; W over bf16
    # activations: dU[:, :2H] of the 4 encoder layers, dW and dU[:, :2H] of
    # the 2 + 1 bf16 head cells and the 2 bf16 heads' dWo (4 + 8 = 12), over
    # float32 operands: dU[:, 2H:] (r * h) of the 4 layers and 3 bf16 head
    # cells and the velocity head's dW, dU[:, :2H], dU[:, 2H:] and dWo (11)
    "wide_bf16": {"gru_encoder_scan": 4, "gru_layer_xp_bwd_bf16": 4,
                  "gru_decode_train_wide_bf16": 2, "gru_decode_train_wide": 1,
                  "gru_decode_bwd_wide_bf16": 2, "gru_decode_bwd_wide": 1,
                  "grad_reduce_bf16": 12, "grad_reduce": 11},
    # with fused_train_encoder=False the encoder is kernel X with its remat
    # backward (no G, no encoder W); with fused_train_decoder=False every
    # head cell runs T's bf16 build (no wide D or E, no head W)
    "wide_bf16_no_fused_encoder": {"gru_encoder_scan": 4, "gru_decode_train_wide_bf16": 2,
                                   "gru_decode_train_wide": 1, "gru_decode_bwd_wide_bf16": 2,
                                   "gru_decode_bwd_wide": 1, "grad_reduce_bf16": 8,
                                   "grad_reduce": 7},
    # (T at H = 512, B = 256 takes its two-launch route: two launches a
    # cell and step)
    "wide_bf16_no_fused_decoder": {"gru_encoder_scan": 4, "gru_layer_xp_bwd_bf16": 4,
                                   "gru_step_bf16": 2 * S_PER_STEP, "grad_reduce_bf16": 4,
                                   "grad_reduce": 4},
    # the bf16 LSTM with the default flags (its fused_train_decoder=False
    # variant decodes the same way: S per head cell and step): LSTM(256) at
    # B = 256 runs L and N in bf16 per encoder layer (rows 19 and 20), W
    # over the bf16 x and h_{t-1} (dW + db, dU: 2 a layer, the velocity
    # layer's too); LSTM(512) Q and R in bf16 (rows 17 and 18), W dU alone
    "lstm_bf16": {"lstm_layer_fwd_bf16": 4, "lstm_layer_bwd_bf16": 4,
                  "lstm_layer_bwd_gates_bf16": 4, "lstm_layer_bwd_chain_bf16": 4,
                  "lstm_layer_bwd_dx_bf16": 1, "lstm_step_bf16": S_PER_STEP,
                  "grad_reduce_bf16": 8},
    "lstm_512_bf16": {"lstm_layer_xp_fwd_bf16": 4, "lstm_layer_xp_bwd_bf16": 4,
                      "lstm_layer_xp_bwd_gates_bf16": 4, "lstm_layer_xp_bwd_chain_bf16": 4,
                      "lstm_step_bf16": S_PER_STEP, "grad_reduce_bf16": 4},
}
# decode_residual_bf16 (the soak's residual_bf16, held_residual_bf16): the
# notes + velocity (+ held) multi-head call through D's and E's
# bf16-residual builds, the instrument head through the float32 ones; W
# over the rounded h sequences for each multi-head head's dWo and the notes
# layer 2's dW (x = the rounded h1), in float32 for the rest: 3 per encoder
# layer (4, or 5 with the held-notes branch), the instrument head's 4, and
# the multi-head cells' dU over h_{t-1} beside the unrounded initial state,
# r * h and layer 1's dW over the float32 probs (5 + 3 per side head)
PER_TRAIN_STEP.update({
    "residual_bf16": {"gru_layer_fwd": 4, "gru_layer_bwd": 4, "gru_decode_train_resid": 2,
                      "gru_decode_train": 1, "gru_decode_bwd_resid": 1, "gru_decode_bwd": 1,
                      "grad_reduce_bf16": 3, "grad_reduce": 24},
    "held_residual_bf16": {"gru_layer_fwd": 5, "gru_layer_bwd": 5, "gru_decode_train_resid": 3,
                           "gru_decode_train": 1, "gru_decode_bwd_resid": 1,
                           "gru_decode_bwd": 1, "grad_reduce_bf16": 4, "grad_reduce": 30},
    # meta_held_notes in float32: the held-notes branch (A + C, W 3) and the
    # held head in the multi-head call (three heads in one E launch, D one a
    # head)
    "held_notes": {"gru_layer_fwd": 5, "gru_layer_bwd": 5, "gru_decode_train": 4,
                   "gru_decode_bwd": 2, "grad_reduce": 34},
    # held_bf16: as "bf16" with the held branch (A, C bf16 and its W) and the
    # held head (D = 2 < 8: promoted to float32, as velocity)
    "held_bf16": {"gru_layer_fwd_bf16": 5, "gru_layer_bwd_bf16": 5, "gru_decode_train_bf16": 2,
                  "gru_decode_train": 2, "gru_decode_bwd_bf16": 2, "gru_decode_bwd": 2,
                  "grad_reduce_bf16": 18, "grad_reduce": 16},
    # the bf16 GRU(512) at B = 128 (the TPU's rows per part): notes L1 and
    # the branches through A and C in bf16 (rows 1, 4), notes L2 through X
    # and G bf16 (rows 9, 10), the notes head through the wide D and E in
    # bf16 (rows 13, 14), the instrument head's rows 7 and 8 through the wide
    # D's bf16 build and E's row-8 build, the velocity head's (float32)
    # through the wide float32 builds; W: 2 + 1 per A + C layer, 1 + 1 for
    # notes L2's dU, 5 + 2 for the notes head, 3 + 1 for the instrument
    # head, 4 float32 for the velocity head
    "bf16_128_512": {"gru_layer_fwd_bf16": 3, "gru_layer_bwd_bf16": 3, "gru_encoder_scan": 1,
                     "gru_layer_xp_bwd_bf16": 1, "gru_decode_train_wide_bf16": 2,
                     "gru_decode_train_wide": 1, "gru_decode_bwd_wide_bf16": 1,
                     "gru_decode_bwd_wide_row8_bf16": 1, "gru_decode_bwd_wide": 1,
                     "grad_reduce_bf16": 15, "grad_reduce": 11},
})
# the bf16 GRU(1024) (the TPU's rows at this width, B 16 to 256): every
# encoder layer through X and G bf16 (rows 11, 12), the notes head the plain
# scan (the XLA scan there), the instrument head through the wide D and E in
# bf16 (rows 13, 14), the velocity head (float32) through their float32
# builds; W: 4 + 3 over bf16 activations (the layers' dU[:, :2H], the
# instrument cell's dW and dU[:, :2H], its dWo), 4 + 1 + 4 over float32
# operands (r * h of the 4 layers and the instrument cell, the velocity
# head's dW, dU[:, :2H], dU[:, 2H:] and dWo)
PER_TRAIN_STEP["wide1024_bf16"] = {"gru_encoder_scan": 4, "gru_layer_xp_bwd_bf16": 4,
                                   "gru_decode_train_wide_bf16": 1, "gru_decode_train_wide": 1,
                                   "gru_decode_bwd_wide_bf16": 1, "gru_decode_bwd_wide": 1,
                                   "grad_reduce_bf16": 7, "grad_reduce": 9}
PER_TRAIN_STEP["lstm_bf16_no_fused_decoder"] = PER_TRAIN_STEP["lstm_bf16"]
PER_TRAIN_STEP["lstm_512_bf16_no_fused_decoder"] = PER_TRAIN_STEP["lstm_512_bf16"]
PER_EVAL_BATCH = {  # forward only
    "narrow": {"gru_layer_fwd": 4, "gru_decode_train": 3},
    "wide": {"gru_layer_xp_fwd": 4, "gru_decode_train_wide": 3},
    "lstm_narrow": {"lstm_layer_fwd": 4, "lstm_step": S_PER_STEP},
    "lstm_wide": {"lstm_layer_xp_fwd": 4, "lstm_step": S_PER_STEP},
    "merge": {"gru_layer_fwd": 4, "gru_step": 2 * 64 + 64, "gru_decode_train": 1},
    "no_fused_train": {"gru_step_xp": S_PER_STEP, "gru_step": S_PER_STEP},
    "lstm_no_fused_encoder": {"lstm_step_xp": S_PER_STEP, "lstm_step": S_PER_STEP},
    "bf16_no_fused_train": {"gru_encoder_scan": 4, "gru_step_bf16": S_PER_STEP},
    "lstm_bf16_no_fused_encoder": {"lstm_encoder_scan": 4, "lstm_step_bf16": S_PER_STEP},
    "bf16": {"gru_layer_fwd_bf16": 4, "gru_decode_train_bf16": 2, "gru_decode_train": 1},
    "wide_bf16": {"gru_encoder_scan": 4, "gru_decode_train_wide_bf16": 2,
                  "gru_decode_train_wide": 1},
    "lstm_bf16": {"lstm_layer_fwd_bf16": 4, "lstm_step_bf16": S_PER_STEP},
    "residual_bf16": {"gru_layer_fwd": 4, "gru_decode_train_resid": 2, "gru_decode_train": 1},
    "bf16_128_512": {"gru_layer_fwd_bf16": 3, "gru_encoder_scan": 1,
                     "gru_decode_train_wide_bf16": 2, "gru_decode_train_wide": 1},
    "wide1024_bf16": {"gru_encoder_scan": 4, "gru_decode_train_wide_bf16": 1,
                      "gru_decode_train_wide": 1},
}
# an encode pass (the serving encoder in float32, kernel A or L, also for a
# bf16 model: the JAX package's encode casts nothing): the test split's
# history at each evaluation, the z cache's seeding on --resume
PER_ENCODE_BATCH = {"GRU": {"gru_layer_fwd": 4}, "LSTM": {"lstm_layer_fwd": 4}}
# one teacher-forced step of the default config: the notes head is a plain
# scan over its ground truth, velocity and instrument are decoded alone
PER_TF_STEP = {"gru_layer_fwd": 4, "gru_layer_bwd": 4, "gru_decode_train": 2,
               "gru_decode_bwd": 2, "grad_reduce": 20}
# encode 4 layers, decode 3 heads
PER_SONG_TRANSFER = {"GRU": {"gru_layer_fwd": 4, "gru_decode": 3},
                     "LSTM": {"lstm_layer_fwd": 4, "lstm_decode": 3}}
# the builds of D, one launch a head, by their counters' names
D_COUNTERS = ("gru_decode_train", "gru_decode_train_bf16", "gru_decode_train_resid")


def fwd_phases(want):
    """``want`` with the phases of kernels L and A: at the paths' widths (H =
    256, 512) each call of L (``lstm_layer_fwd``, which ``read_counters``
    derives from its phases) or of A (``gru_layer_fwd``, derived the same
    way) runs its pre-pass and its chain once; its per-block route none.
    Every launch of B (``gru_decode``), of M (``lstm_decode``) and of D's
    builds (D, D bf16, D resid: one a head) there is its chain's
    (``gru_decode_chain``, ``lstm_decode_chain``,
    ``gru_decode_train_chain`` and its ``_bf16``, ``_resid``)."""
    out = dict(want)
    for op in ("gru_decode", "lstm_decode", *D_COUNTERS):
        if want.get(op):
            name = op.replace("_bf16", "").replace("_resid", "") + "_chain"
            out[name + op[len(op.replace("_bf16", "").replace("_resid", "")):]] = want[op]
    for sfx in ("", "_bf16"):
        for op, phases in (("lstm_layer_fwd", ("lstm_layer_xproj", "lstm_layer_fwd_chain")),
                           ("gru_layer_fwd", ("gru_layer_xproj", "gru_layer_fwd_chain"))):
            n = want.get(f"{op}{sfx}", 0)
            if n:
                out.update({f"{p}{sfx}": n for p in phases})
    return out


# the layers of a step's E calls (the notes head 2, every other head 1), by
# the heads' dtype (float32, bf16): E's pre-pass launches twice a layer
E_LAYERS = {"narrow": (4, 0), "wide": (4, 0), "merge": (1, 0), "bf16": (1, 3),
            "merge_bf16": (0, 1), "wide_bf16": (1, 3), "wide_bf16_no_fused_encoder": (1, 3),
            "residual_bf16": (4, 0), "held_residual_bf16": (5, 0), "held_notes": (5, 0),
            "held_bf16": (2, 3), "bf16_128_512": (1, 3), "wide1024_bf16": (1, 1), "tf": (2, 0)}


def bwd_phases(want, dx=1, e_layers=(0, 0)):
    """``want`` with the phases of kernels C and E: each call of C
    (``gru_layer_bwd``) runs its gate pre-pass (two launches: P1, P2) and
    its chain once, its dx pass where the layer's dx is wanted (``dx``
    layers: the notes stack's second, whose input is not the batch; none
    where that layer runs elsewhere); each call of E, whatever its build,
    runs its chain once and its pre-pass twice a layer of its heads
    (``e_layers``: the layers of the calls, float32 and bf16), counted by
    the heads' dtype."""
    out = dict(want)
    for sfx in ("", "_bf16"):
        n = want.get(f"gru_layer_bwd{sfx}", 0)
        if n:
            out.update({f"gru_layer_bwd_gates{sfx}": 2 * n, f"gru_layer_bwd_chain{sfx}": n})
            if dx:
                out[f"gru_layer_bwd_dx{sfx}"] = dx
    for sfx, builds, layers in (
            ("", ("gru_decode_bwd", "gru_decode_bwd_resid", "gru_decode_bwd_wide"), e_layers[0]),
            ("_bf16", ("gru_decode_bwd_bf16", "gru_decode_bwd_wide_bf16",
                       "gru_decode_bwd_wide_row8_bf16"), e_layers[1])):
        n = sum(want.get(k, 0) for k in builds)
        if n:
            if not layers:
                raise RuntimeError(f"the launch tables give {n} E calls but no layers ({sfx})")
            out.update({f"gru_decode_bwd_gates{sfx}": 2 * layers,
                        f"gru_decode_bwd_chain{sfx}": n})
    return out


def xp_phases(want):
    """``want`` with the phases of kernels X and G and the routes of F and
    the wide D: at the paths' widths (H = 256, 512) every launch of X
    (``gru_encoder_scan``), of F (``gru_layer_xp_fwd``) and of the wide D
    (``gru_decode_train_wide``, per build: one a head) is its chain's, and
    each call of G (``gru_layer_xp_bwd``, per build) runs its xp gate
    pre-pass (two launches: P1, P2) and its chain (C's) once; their
    per-block routes none."""
    out = dict(want)
    for op in ("gru_encoder_scan", "gru_layer_xp_fwd", "gru_decode_train_wide",
               "gru_decode_train_wide_bf16"):
        if want.get(op):
            out[op.replace("_bf16", "") + "_chain" + ("_bf16" if op.endswith("_bf16") else "")] = want[op]
    for sfx in ("", "_bf16"):
        n = want.get(f"gru_layer_xp_bwd{sfx}", 0)
        if n:
            out.update({f"gru_layer_xp_bwd_gates{sfx}": 2 * n, f"gru_layer_xp_bwd_chain{sfx}": n})
    return out


# the bf16 GRU(512) at B = 128 runs its notes layer 2 through X and G: its C
# layers (notes layer 1, the branches) all take the batch
for _key, _table in (*PER_TRAIN_STEP.items(), *PER_EVAL_BATCH.items(),
                     *PER_ENCODE_BATCH.items(), *PER_SONG_TRANSFER.items(), ("tf", PER_TF_STEP)):
    _table.update(xp_phases(bwd_phases(fwd_phases(_table), dx=0 if _key == "bf16_128_512" else 1,
                                       e_layers=E_LAYERS.get(_key, (0, 0)))))


# the counters of N's and R's phases (one launch each per op call; dx where
# the layer's dx is wanted)
BPTT_PHASES = ("lstm_layer_bwd_gates", "lstm_layer_bwd_chain", "lstm_layer_bwd_dx",
               "lstm_layer_xp_bwd_gates", "lstm_layer_xp_bwd_chain")
# L's and A's: the pre-pass and the chain, and the per-block route
L_PHASES = ("lstm_layer_xproj", "lstm_layer_fwd_chain", "lstm_layer_block")
A_PHASES = ("gru_layer_xproj", "gru_layer_fwd_chain", "gru_layer_block")
# C's and E's: the gate pre-pass, the chain and C's dx pass
C_PHASES = ("gru_layer_bwd_gates", "gru_layer_bwd_chain", "gru_layer_bwd_dx")
E_PHASES = ("gru_decode_bwd_gates", "gru_decode_bwd_chain")
# G's: the xp gate pre-pass, the chain (C's) and the per-block route
G_PHASES = ("gru_layer_xp_bwd_gates", "gru_layer_xp_bwd_chain", "gru_layer_xp_bwd_block")


def route_key(cfg, route):
    """The key of the launch tables: the route, prefixed for LSTM."""
    return f"lstm_{route}" if cfg.cell_type == "LSTM" else route


def kernel_counters():
    """Kernel name -> (wrapper, its counter attribute): ``launches``, or
    ``launches_bf16`` for the bf16 builds of T, S, A, C, D, E, G, the wide D
    and E, W, L, N, Q and R, ``launches_resid`` for D's and E's
    bf16-residual builds, ``launches_row8_bf16`` for E wide's row-8 build,
    ``launches_chain`` and ``launches_block`` for the two routes of X, F,
    M and every build of D (with the build's suffix: ``_bf16``,
    ``_resid``)."""
    from midi_vae_tpu_torch.ops import encoder_scan as es
    from midi_vae_tpu_torch.ops import encoder_stack as est
    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops import gru_layer as gl
    from midi_vae_tpu_torch.ops import gru_step as gs
    from midi_vae_tpu_torch.ops import lstm_layer as ll
    from midi_vae_tpu_torch.ops import lstm_step as ls
    from midi_vae_tpu_torch.ops.grad_reduce import grad_reduce
    from midi_vae_tpu_torch.ops.lstm_decode import lstm_decode

    fns = {"gru_decode": gd.gru_decode,
           "gru_layer_bwd": gl.gru_layer_bwd, "gru_decode_train": gd.gru_decode_fwd_train,
           "gru_decode_bwd": gd.gru_decode_bwd, "grad_reduce": grad_reduce,
           "gru_layer_xp_fwd": gl.gru_layer_xp, "gru_layer_xp_bwd": gl.gru_layer_xp_bwd,
           "gru_decode_train_wide": gd.gru_decode_fwd_train_wide,
           "gru_decode_bwd_wide": gd.gru_decode_bwd_wide,
           "lstm_decode": lstm_decode,
           "lstm_layer_bwd": ll.lstm_layer_bwd, "lstm_layer_xp_fwd": ll.lstm_layer_xp,
           "lstm_layer_xp_bwd": ll.lstm_layer_xp_bwd, "lstm_step": ls.lstm_cell_step_fwd,
           "lstm_layer_bwd_gates": ll.lstm_layer_bwd_gates,
           "lstm_layer_bwd_chain": ll.lstm_layer_bwd_chain,
           "lstm_layer_bwd_dx": ll.lstm_layer_bwd_dx,
           "lstm_layer_xp_bwd_gates": ll.lstm_layer_xp_bwd_gates,
           "lstm_layer_xp_bwd_chain": ll.lstm_layer_xp_bwd_chain,
           **{name: getattr(ll, name) for name in L_PHASES},
           **{name: getattr(gl, name) for name in A_PHASES},
           **{name: getattr(gl, name) for name in C_PHASES},
           **{name: getattr(gd, name) for name in E_PHASES},
           **{name: getattr(gl, name) for name in G_PHASES},
           "lstm_step_xp": ls.lstm_recurrent_step_fwd, "gru_step": gs.gru_cell_step_fwd,
           "gru_step_xp": gs.gru_recurrent_step_fwd,
           "gru_encoder_scan": es.gru_encoder_scan_fwd,
           "lstm_encoder_scan": es.lstm_encoder_scan_fwd,
           "gru_encoder_stack_fwd": est.gru_encoder_stack_fwd,
           "gru_encoder_stack_bwd": est.gru_encoder_stack_bwd}
    counters = {name: (fn, "launches") for name, fn in fns.items()}
    for name in ("gru_step", "lstm_step", "gru_layer_bwd", "gru_decode_train",
                 "gru_decode_bwd", "grad_reduce", "gru_layer_xp_bwd", "gru_decode_train_wide",
                 "gru_decode_bwd_wide", "lstm_layer_bwd", "lstm_layer_xp_fwd",
                 "lstm_layer_xp_bwd", *BPTT_PHASES, *L_PHASES, *A_PHASES, *C_PHASES,
                 *E_PHASES, *G_PHASES):
        counters[f"{name}_bf16"] = (counters[name][0], "launches_bf16")
    # X's, F's and the wide D's chains and per-block routes (``launches``:
    # either; the wide D per build)
    counters["gru_encoder_scan_chain"] = (es.gru_encoder_scan_fwd, "launches_chain")
    counters["gru_encoder_scan_block"] = (es.gru_encoder_scan_fwd, "launches_block")
    for route in ("chain", "block"):
        counters[f"gru_layer_xp_fwd_{route}"] = (gl.gru_layer_xp, f"launches_{route}")
        for sfx in ("", "_bf16"):
            counters[f"gru_decode_train_wide_{route}{sfx}"] = (gd.gru_decode_fwd_train_wide,
                                                               f"launches_{route}{sfx}")
    counters["gru_decode_chain"] = (gd.gru_decode, "launches_chain")
    counters["gru_decode_train_resid"] = (gd.gru_decode_fwd_train, "launches_resid")
    # D's and M's chains and per-block routes (D per build)
    for route in ("chain", "block"):
        for sfx in ("", "_bf16", "_resid"):
            counters[f"gru_decode_train_{route}{sfx}"] = (gd.gru_decode_fwd_train,
                                                          f"launches_{route}{sfx}")
        counters[f"lstm_decode_{route}"] = (lstm_decode, f"launches_{route}")
    counters["gru_decode_bwd_resid"] = (gd.gru_decode_bwd, "launches_resid")
    counters["gru_decode_bwd_wide_row8_bf16"] = (gd.gru_decode_bwd_wide, "launches_row8_bf16")
    return counters


def reset_counters():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_counters():
    """The counters that moved (a kernel absent from the dict ran 0 times),
    and the calls of L (``lstm_layer_fwd``, ``lstm_layer_fwd_bf16``) and of A
    (``gru_layer_fwd``, ``gru_layer_fwd_bf16``): the launches of the layer's
    pre-pass and of its per-block route, one of which each call of
    ``lstm_layer`` or ``gru_layer`` takes."""
    found = {name: getattr(fn, attr) for name, (fn, attr) in kernel_counters().items()
             if getattr(fn, attr)}
    for op in ("lstm_layer", "gru_layer"):
        for sfx in ("", "_bf16"):
            calls = found.get(f"{op}_xproj{sfx}", 0) + found.get(f"{op}_block{sfx}", 0)
            if calls:
                found[f"{op}_fwd{sfx}"] = calls
    return found


def expected_train_launches(cfg, key, n_train, n_test, epochs):
    """Launches of fit() over ``epochs`` (``key``: the launch tables' row of
    the config): its train steps; with history, the z cache's seeding pass
    over the train split when the run resumes past epoch 0 (or, with
    ``history_from_train_z=False``, an encode pass at each epoch after the
    first); test evaluation every test_step epochs with its own history
    pass."""
    bs = cfg.batch_size
    n_batches, n_test_batches = -(-n_train // bs), -(-n_test // bs)
    steps = encodes = evals = 0
    for e in epochs:
        steps += n_batches
        if cfg.history and e > 0 and (not cfg.history_from_train_z or e == epochs.start):
            encodes += n_batches
        if n_test and e % cfg.test_step == 0:
            encodes += n_test_batches if cfg.history else 0
            evals += n_test_batches
    want = {}
    for table, times in ((PER_TRAIN_STEP[key], steps), (PER_EVAL_BATCH[key], evals),
                         (PER_ENCODE_BATCH[cfg.cell_type], encodes)):
        for name, per in table.items():
            if per * times:
                want[name] = want.get(name, 0) + per * times
    return want


def phase_train_slice(work, sets=(), key=None):
    """The train CLI at full width (``sets``: its --set overrides) on an
    authored corpus: 2 epochs, then --resume for a third, then the transfer
    CLI serves the run. ``key``: the launch tables' row (default: the
    route's)."""
    import numpy as np

    from midi_vae_tpu_torch.config import Config, parse_overrides
    from midi_vae_tpu_torch.data import smf
    from midi_vae_tpu_torch.data.batching import flatten_dataset
    from midi_vae_tpu_torch.data.dataset import import_midi_from_folder
    from midi_vae_tpu_torch.cli import train as train_cli
    from midi_vae_tpu_torch.cli import transfer
    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.training import checkpoint as ckpt

    from midi_vae_tpu_torch.tools import make_demo_corpus as corpus

    rng = np.random.RandomState(1)
    source = os.path.join(work, "corpus")
    for style in ("style1", "style2"):
        os.makedirs(os.path.join(source, style))
        for i in range(10):  # about 290 train windows: a full batch of 256 and a padded one
            corpus.make_song(corpus.STYLES[style], rng).write(os.path.join(source, style, f"{style}_{i}.mid"))
    run, cache = os.path.join(work, "train_run"), os.path.join(work, "cache")
    cfg = Config(**parse_overrides(list(sets)))
    route = _layout.config_route(cfg)
    key = key or route_key(cfg, route)
    tag = f"{cfg.cell_type}({cfg.lstm_size}), {route} route{', ' + key if key != route else ''}"
    train, test, _, _ = flatten_dataset(import_midi_from_folder(source, cfg, cache_dir=cache), cfg)
    args = ["--source", source, "--output", run, "--cache", cache, "--device", "cuda"]
    for kv in sets:
        args += ["--set", kv]
    results = {}
    for label, extra, epochs in (("2 epochs", ["--epochs", "2"], range(0, 2)),
                                 ("resume", ["--epochs", "3", "--resume"], range(2, 3))):
        reset_counters()
        t0 = time.perf_counter()
        rc = train_cli.main(args + extra)
        secs = time.perf_counter() - t0
        launches = read_counters()
        if rc != 0:
            raise RuntimeError(f"train CLI ({label}) returned {rc}")
        want = expected_train_launches(cfg, key, train.num_windows, test.num_windows, epochs)
        if launches != want:
            raise RuntimeError(f"train CLI ({label}): launch counters {launches}, expected {want}")
        with open(os.path.join(run, "history.json")) as f:
            hist = json.load(f)
        losses = [e["loss"] for e in hist["train"]] + [e["loss"] for e in hist["test"]]
        if hist["epoch"] != list(range(epochs.stop)) or not np.all(np.isfinite(losses)):
            raise RuntimeError(f"train CLI ({label}): history {hist['epoch']}, losses {losses}")
        if ckpt.latest_epoch(run) != epochs.stop - 1:
            raise RuntimeError(f"train CLI ({label}): latest checkpoint {ckpt.latest_epoch(run)}")
        results[label] = launches
        print(f"[train] CLI {label} ({tag}): {train.num_windows} train / {test.num_windows} test windows, "
              f"{secs:.2f} s; train losses {[round(x, 4) for x in losses[:epochs.stop]]}; "
              f"launches {launches} (as designed)")
    out = os.path.join(work, "train_out")
    song = os.path.join(source, "style1", "style1_0.mid")
    reset_counters()
    rc = transfer.main(["--model", run, "--input", song, "--to-class", "style2", "--output", out,
                        "--device", "cuda"])
    if rc != 0:
        raise RuntimeError(f"the transfer CLI returned {rc} on the trained run")
    per_song = PER_SONG_TRANSFER[cfg.cell_type]
    if read_counters() != per_song:
        raise RuntimeError(f"serving the trained run launched {read_counters()}, expected "
                           f"{per_song}")
    # a model 3 epochs old predicts mostly the silent note: the song must be
    # written and parse back, its notes may be few
    mid = smf.read_midi(os.path.join(out, "style1_0_style1_to_style2.mid"))
    notes = sum(len(inst.notes) for inst in mid.instruments)
    print(f"[train] the transfer CLI served the trained run ({tag}, epoch 2 params): a .mid that "
          f"parses back, {len(mid.instruments)} instruments, {notes} notes; launches {per_song}")
    return results["2 epochs"]


def argmax_flips(cfg, params, batch, noise, label):
    """Prints, for each categorical output of one training forward (the
    heads' and the composer's logits) whose argmax differs between the card
    and the CPU plain path on a valid row, each such row's two classes, the
    margin by which each device prefers its own (the logit gap), the
    largest |card - CPU| of that output's logits over the valid rows (the
    rounding noise a flip is measured against) and the CPU's smallest
    top-2 gap there; returns those records."""
    import torch

    from midi_vae_tpu_torch.training.trainer import VAETrainer

    outs = {}
    for name, device in (("card", "cuda"), ("cpu", "cpu")):
        trainer = VAETrainer(cfg, device)
        with torch.no_grad():
            out = trainer.new_state(params).model.apply(trainer.to_device(batch),
                                                        noise=torch.as_tensor(noise, device=device))
        found = {f"{k} logits": lg for k, (_p, lg) in out["heads"].items()}
        if "composer_logits" in out:
            found["composer logits"] = out["composer_logits"]
        outs[name] = {k: v.float().cpu() for k, v in found.items() if v.shape[-1] > 1}
    valid = torch.as_tensor(batch["M"]).bool() if "M" in batch else None
    records = []
    for what, cpu in outs["cpu"].items():
        card = outs["card"][what]
        if valid is not None:
            card, cpu = card[valid], cpu[valid]
        card, cpu = card.reshape(-1, card.shape[-1]), cpu.reshape(-1, cpu.shape[-1])
        a, b = cpu.argmax(-1), card.argmax(-1)
        noise_ = (card - cpu).abs().max().item()
        top2 = cpu.topk(2, -1).values
        for r in torch.nonzero(a != b).flatten().tolist():
            rec = {"output": what, "row": r, "cpu_class": a[r].item(), "card_class": b[r].item(),
                   "cpu_margin": (cpu[r, a[r]] - cpu[r, b[r]]).item(),
                   "card_margin": (card[r, b[r]] - card[r, a[r]]).item(),
                   "max_abs_logit_diff": noise_,
                   "cpu_min_top2_gap": (top2[:, 0] - top2[:, 1]).min().item()}
            records.append(rec)
            print(f"[{label} card vs cpu] argmax flip in the {what}, valid row {r}: the CPU "
                  f"prefers class {rec['cpu_class']} by {rec['cpu_margin']:.4e}, the card class "
                  f"{rec['card_class']} by {rec['card_margin']:.4e}; max |card - CPU| over the "
                  f"output's logits {noise_:.4e}, the CPU's smallest top-2 gap {rec['cpu_min_top2_gap']:.4e}")
    return records


def phase_train_card_vs_cpu(smi, cfg, per_step, label):
    """One training step of ``cfg`` on a fixed batch of ``cfg.batch_size``
    windows with padding rows and numpy noise: loss, metrics and every
    parameter gradient, card against the CPU plain path (a bf16 ``cfg`` to
    the BF16_* limits), with the card's launch counters equal to
    ``per_step``; then the card's step time."""
    import numpy as np
    import torch

    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.tools.profile_train import random_train_batch
    from midi_vae_tpu_torch.training.trainer import VAETrainer

    rows = cfg.batch_size
    params = MidiVAE(cfg).init_params(np.array([0, cfg.seed], np.uint32))
    batch = random_train_batch(cfg, rows, 4, valid=rows - 6)
    noise = (cfg.epsilon_std * np.random.RandomState(5).randn(rows, cfg.latent_dim)).astype(np.float32)
    got = {}
    for device in ("cuda", "cpu"):
        trainer = VAETrainer(cfg, device)
        state = trainer.new_state(params)
        reset_counters()
        loss, metrics, grads = trainer.value_and_grad(state, trainer.to_device(batch),
                                                      torch.as_tensor(noise, device=device))
        if device == "cuda":
            torch.cuda.synchronize()
            launches = read_counters()
            if launches != per_step:
                raise RuntimeError(f"{label}: one step launched {launches}, expected {per_step}")
        got[device] = (loss.item(), {k: v.item() for k, v in metrics.items()},
                       [g.cpu() for g in grads], state.opt_state.names)
    (gl, gm, gg, names), (cl, cm, cg, _) = got["cuda"], got["cpu"]
    bf16 = cfg.compute_dtype == "bfloat16"
    loss_atol, acc_atol = (BF16_LOSS_ATOL, BF16_ACC_ATOL) if bf16 else (LOSS_ATOL, ACC_ATOL)
    errs = {"loss": abs(gl - cl)}
    if any(gm[k] != v for k, v in cm.items() if k.endswith("_acc")):
        argmax_flips(cfg, params, batch, noise, label)
    for k, v in cm.items():
        errs[k] = abs(gm[k] - v)
        limit = acc_atol if k.endswith("_acc") else loss_atol
        if not (np.isfinite(gm[k]) and errs[k] <= limit):
            raise RuntimeError(f"{label} metric {k}: card {gm[k]}, CPU {v}, limit {limit}")
    worst = (0.0, "")
    for name, g, c in zip(names, gg, cg):
        err = (g - c).abs().max().item()
        if bf16:
            limit = BF16_GRAD_REL_MAX * c.abs().max().item() + STEP_GRAD_ATOL
            rel_l2 = ((g - c).norm() / c.norm().clamp_min(1e-12)).item()
            if not (torch.isfinite(g).all() and err <= limit and rel_l2 <= BF16_GRAD_REL_L2):
                raise RuntimeError(f"{label} grad {name}: max|card - CPU| {err:.3e} (limit "
                                   f"{limit:.3e}), relative L2 {rel_l2:.3e} (limit "
                                   f"{BF16_GRAD_REL_L2:.0e})")
            worst = max(worst, (max(err / limit, rel_l2 / BF16_GRAD_REL_L2), name))
            continue
        limit = STEP_GRAD_RTOL * c.abs().max().item() + STEP_GRAD_ATOL
        if not (torch.isfinite(g).all() and err <= limit):
            raise RuntimeError(f"{label} grad {name}: max|card - CPU| {err:.3e} > {limit:.3e}")
        worst = max(worst, (err / limit, name))
    print(f"[{label} card vs cpu] one step, {rows} windows ({rows - 6} valid): |dloss| "
          f"{errs['loss']:.3e}, max |dmetric| {max(errs.values()):.3e}; all {len(names)} gradients "
          f"within limits (closest: {worst[1]} at {worst[0]:.3f} of its limit); launches {per_step}")

    trainer = VAETrainer(cfg, "cuda")
    state = trainer.new_state(params)
    tb = trainer.to_device(batch)
    trainer.train_step(state, tb)
    ms = median_ms(lambda: trainer.train_step(state, tb), STEP_REPS)
    steps = rows * cfg.output_length
    print(f"[{label} card vs cpu] training step on the card {ms:.3f} ms (median of {STEP_REPS}, CUDA "
          f"events) = {steps / ms * 1e3:.1f} note-steps/s on {smi}")
    return {"step_ms": ms, "note_steps_per_s": steps / ms * 1e3,
            "max_abs_dloss": errs["loss"], "closest_grad_to_limit": worst[0],
            "launches": launches}


def phase_card_vs_cpu(smi, cell_type="GRU", overrides=None, params=None):
    """One 256-window transfer_argmax batch of ``Config(cell_type=...,
    **overrides)`` (its seeded init, or ``params``: a trained run's): card
    against the CPU plain path; then the card's transfer rate at B = 256 and
    one song's latency at B = 16 (host clock around work that ends in a
    synchronize, median of REPS)."""
    import numpy as np
    import torch

    from midi_vae_tpu_torch import bridge
    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.evaluation.generation import GenerationContext
    from midi_vae_tpu_torch.models.vae import MidiVAE

    cfg = Config(cell_type=cell_type, **(overrides or {}))
    params = bridge.to_tree(MidiVAE(cfg).params) if params is None else params
    batch = random_batch(cfg, B, 2)
    results, timing = {}, {}
    for device in ("cuda", "cpu"):
        ctx = GenerationContext(cfg, MidiVAE(cfg, params), device)
        perm = torch.arange(cfg.latent_dim, device=device)
        perm[[0, 1]] = perm[[1, 0]]
        dev_batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
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
        if device != "cuda":
            continue
        for rows in (B, 16):
            part = {k: v[:rows].contiguous() for k, v in dev_batch.items()}
            ctx.transfer_argmax(part, perm, A[:rows])
            torch.cuda.synchronize()
            times = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                out = ctx.transfer_argmax(part, perm, A[:rows])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                del out
            times.sort()
            timing[rows] = times[len(times) // 2]
    gpu, cpu = results["cuda"], results["cpu"]
    z_err = float(np.abs(gpu["z"] - cpu["z"]).max())
    p_err = max(float(np.abs(gpu["probs"][k] - cpu["probs"][k]).max()) for k in cpu["probs"])
    agree = float(np.mean(gpu["notes_idx"] == cpu["notes_idx"]))
    for k, v in gpu["probs"].items():
        if not np.isfinite(v).all():
            raise RuntimeError(f"card probs of head {k} ({cell_type}) are not finite")
    if not (z_err <= Z_ATOL and p_err <= PROBS_ATOL and agree >= MIN_ARGMAX_AGREEMENT):
        raise RuntimeError(f"card vs CPU ({cell_type}): max|dz| {z_err:.3e} (limit {Z_ATOL:.0e}), "
                           f"max|dprobs| {p_err:.3e} (limit {PROBS_ATOL:.0e}), notes argmax "
                           f"agreement {agree:.5f} (limit {MIN_ARGMAX_AGREEMENT})")
    secs = timing[B]
    steps = B * cfg.output_length
    print(f"[card vs cpu {cell_type}{overrides or ''}] {B} windows: max|dz| {z_err:.3e}, "
          f"max|dprobs| {p_err:.3e}, "
          f"notes argmax agreement {agree:.5f}; transfer_argmax on the card {secs * 1e3:.3f} ms "
          f"(median of {REPS}) = {B / secs:.1f} windows/s = {steps / secs:.1f} note-steps/s; one "
          f"song (16 windows) {timing[16] * 1e3:.3f} ms; on {smi}")
    return {"cell_type": cell_type, "max_abs_dz": z_err, "max_abs_dprobs": p_err,
            "notes_argmax_agreement": agree, "transfer_ms_b256": secs * 1e3,
            "windows_per_s_b256": B / secs, "song_latency_ms_b16": timing[16] * 1e3}


def phase_judges_card_vs_cpu(cell_type):
    """The judges of all three kinds (RNN(256) x 2 of ``cell_type``) on 256
    windows of their input shapes: card (kernels A or L) against the CPU plain
    path, probs to JUDGE_ATOL."""
    import numpy as np
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.classifier import CLASSIFIER_KINDS, ClassifierSpec, StyleClassifier

    cfg = Config(cell_type=cell_type)
    batch = random_batch(cfg, B, 8)
    inputs = {"pitch": batch["X"], "velocity": batch["V"], "instrument": batch["I"]}
    errs = {}
    for seed, kind in enumerate(CLASSIFIER_KINDS):
        spec = ClassifierSpec.for_kind(kind, cfg)
        probs = {}
        for device in ("cuda", "cpu"):
            model = StyleClassifier(spec, seed=seed).to(device)
            with torch.inference_mode():
                probs[device] = model.predict(torch.as_tensor(inputs[kind], device=device)).cpu().numpy()
        errs[kind] = float(np.abs(probs["cuda"] - probs["cpu"]).max())
        if not (np.isfinite(probs["cuda"]).all() and errs[kind] <= JUDGE_ATOL):
            raise RuntimeError(f"{cell_type} judge {kind}: max |card - CPU| {errs[kind]:.3e} > "
                               f"{JUDGE_ATOL:.0e}")
    print(f"[judges card vs cpu {cell_type}] {B} windows, max |dprobs| per judge: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (limit {JUDGE_ATOL:.0e})")
    return errs


def lstm_bwd_flops(T, B, w, u, dx=True):
    """BPTT of an LSTM layer with x @ W recomputed (N): the gates again from
    x_t @ W and h_{t-1} @ U, dh = da @ U^T and dx = da @ W^T: 2 (d_in (2 with
    dx) + 2 H) 4H multiply-adds a row and step."""
    return 2 * T * B * (w.shape[0] * (2 if dx else 1) + 2 * u.shape[0]) * u.shape[1]


def cudnn_lstm_layer(x, p, h0, c0, xp=False):
    """cuDNN's LSTM (``torch.nn.LSTM``) holding one LSTM layer's weights
    (as ``cudnn_lstm``) or, with ``xp``, the layer over a precomputed
    x-projection x = xp (weight_ih = the identity, bias_ih = 0, so that
    x @ weight_ih^T = xp), in x's dtype: the yardstick ``library_ms`` of L,
    N, Q, R and (bf16) Y; the port never calls it. Returns (forward,
    backward, forward + backward),
    each a callable; the backward is one autograd.grad call over a forward
    run once, for the gradients of x, h0, c0 and the weights."""
    import torch

    G, H = p["u"].shape[1], p["u"].shape[0]
    D = G if xp else p["w"].shape[0]
    lstm = torch.nn.LSTM(D, H).to(x.device, x.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(G, device=x.device) if xp else p["w"].t())
        lstm.weight_hh_l0.copy_(p["u"].t())
        lstm.bias_ih_l0.copy_(torch.zeros(G, device=x.device) if xp else p["b"])
        lstm.bias_hh_l0.zero_()
    leaves = [x.detach().clone().requires_grad_(), h0[None].clone().requires_grad_(),
              c0[None].clone().requires_grad_(), *lstm.parameters()]
    g = torch.ones(x.shape[0], x.shape[1], H, device=x.device, dtype=x.dtype)

    def fwd():
        with torch.no_grad():
            return lstm(leaves[0], (leaves[1], leaves[2]))

    def fwd_bwd():
        out, _ = lstm(leaves[0], (leaves[1], leaves[2]))
        return torch.autograd.grad(out, leaves, g)

    out, _ = lstm(leaves[0], (leaves[1], leaves[2]))
    return fwd, (lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)), fwd_bwd


def loop_times(tag, res, kernel, plain, n, library=None):
    """A per-step cell's ``n`` launches as its head or layer runs them:
    ``kernel``, ``plain`` and ``library`` are loops (callables) over the
    ``n`` steps with the state carried, each timed as one CUDA-event window
    in turns plain, kernel, kernel, plain (``library``, one PyTorch call per
    step that computes the same step, after them). ``res`` is the cell's
    per-launch compare(); returns it as the sum over the ``n`` launches, the
    per-launch times kept beside."""
    import torch

    with torch.no_grad():
        plain_a, kernel_a = median_ms(plain), median_ms(kernel)
        kernel_b, plain_b = median_ms(kernel), median_ms(plain)
        library_ms = median_ms(library) if library is not None else None
    ms, plain_ms = (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2
    lib = f", library {library_ms:.4f} ms" if library is not None else ""
    print(f"[kernels] {tag}, {n} launches in one window: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms{lib}")
    return {k: (v * n if k in ("flops", "bytes", "bound_ms") else v) for k, v in res.items()} | {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "launches_per_step": n,
        "ms_per_launch_alone": res["ms"], "plain_ms_per_launch_alone": res["plain_ms"]}


def carried(step, state, n, xs=None):
    """A loop of ``n`` calls of ``step(state[, xs[t]]) -> state``."""
    def run():
        st = state
        for t in range(n):
            st = step(st) if xs is None else step(st, xs[t])
        return st
    return run


def head_loop_times(name, res, args, n, limits=(H_ATOL, C_ATOL)):
    """S on one head cell as a step's head runs it (``loop_times``), beside
    ``torch.lstm_cell`` (the yardstick ``library_ms``: x @ W + b + h @ U and
    the gates i, f, g, o in one PyTorch call, held to the plain version
    within ``limits``; the port never calls it)."""
    import torch

    from midi_vae_tpu_torch.ops import lstm_step as ls

    x, h0, c0, w, b, u, activation = args
    # the card's fused cell takes both biases
    wt, ut, b_hh = w.t().contiguous(), u.t().contiguous(), torch.zeros_like(b)
    with torch.no_grad():
        # the yardstick computes the same function as the port's step
        check(f"torch.lstm_cell {name}", lambda: torch.lstm_cell(x, (h0, c0), wt, ut, b, b_hh),
              lambda: ls.lstm_cell_step_reference(*args), list(limits))
    return loop_times(
        f"S{' bf16' if x.dtype == torch.bfloat16 else ''} {name}", res,
        carried(lambda hc: ls.lstm_cell_step_fwd(x, *hc, w, b, u, activation), (h0, c0), n),
        carried(lambda hc: ls.lstm_cell_step_reference(x, *hc, w, b, u, activation), (h0, c0), n),
        n, carried(lambda hc: torch.lstm_cell(x, hc, wt, ut, b, b_hh), (h0, c0), n))


def bptt_phase_checks(run, letter, tag, bargs):
    """N's ("N": bargs are lstm_layer_bwd's) or R's ("R": lstm_layer_xp_bwd's)
    phases, each against its plain version on the same inputs: the gate
    pre-pass, the chain over the plain pre-pass's act, N's dx pass over the
    plain chain's gate grads, where the layer's dx is wanted. ``run`` is
    compare (timed, with bounds: the pre-pass's products at the FFMA rate in
    float32 and at the bf16 tensor-core rate in bf16, the chain's dh product
    and the dx pass at the FFMA rate, both taking the float32 gate grads) or
    check. Returns {counter name: result}."""
    import torch

    from midi_vae_tpu_torch.ops import lstm_layer as ll

    if letter == "N":
        x, hseq, cseq, h0, c0, d_seq, d_final, w, b, u, need_dx = bargs
        gargs, gates, gates_ref = (x, hseq, h0, w, b, u), ll.lstm_layer_bwd_gates, (
            lambda: ll.lstm_bwd_gates_reference(x, hseq, h0, u, w, b))
        k_in = x.shape[-1] + u.shape[0]
    else:
        x, hseq, cseq, h0, c0, d_seq, d_final, u = bargs
        need_dx = False
        gargs, gates, gates_ref = (x, hseq, h0, u), ll.lstm_layer_xp_bwd_gates, (
            lambda: ll.lstm_bwd_gates_reference(x, hseq, h0, u))
        k_in = u.shape[0]
    T, rows, H = hseq.shape
    bf16 = x.dtype == torch.bfloat16
    sfx, peak = ("_bf16", PEAK_BF16_FLOPS) if bf16 else ("", PEAK_F32_FLOPS)
    name = "lstm_layer_bwd" if letter == "N" else "lstm_layer_xp_bwd"
    kind = f"{letter}{' bf16' if bf16 else ''}"
    found = {}
    with torch.no_grad():
        act = gates_ref()
    found[f"{name}_gates{sfx}"] = run(
        f"{kind} gate pre-pass {tag}", lambda: gates(*gargs), gates_ref, [rel],
        flops=2 * T * rows * k_in * 4 * H, inputs=gargs, peak=peak)
    cargs = (act, cseq, c0, d_seq, d_final, u)
    if letter == "N":
        chain, chain_ref = ll.lstm_layer_bwd_chain, lambda: tuple(
            t if i == 0 else t.to(x.dtype)
            for i, t in enumerate(ll.lstm_bwd_chain_reference(*cargs)))
        limits = [rel] + [BF16_OUT if bf16 else rel] * 2
    else:
        def chain_ref():
            da, dh0, dc0 = ll.lstm_bwd_chain_reference(*cargs)
            return da.to(x.dtype), dh0.to(x.dtype), dc0.to(x.dtype), da

        chain = ll.lstm_layer_xp_bwd_chain
        limits = [BF16_OUT if bf16 else rel] * 3 + [rel]
    found[f"{name}_chain{sfx}"] = run(
        f"{kind} chain {tag}", lambda: chain(*cargs), chain_ref, limits,
        flops=0.0, flops_f32=2 * T * rows * 4 * H * H, inputs=cargs)
    if need_dx:
        with torch.no_grad():
            da = ll.lstm_bwd_chain_reference(*cargs)[0]
        found[f"{name}_dx{sfx}"] = run(
            f"{kind} dx pass {tag}", lambda: ll.lstm_layer_bwd_dx(da, w),
            lambda: ll.lstm_bwd_dx_reference(da, w), [BF16_OUT if bf16 else rel],
            flops=0.0, flops_f32=2 * T * rows * 4 * H * w.shape[0], inputs=(da, w),
            library_fn=None if bf16 else (lambda: da @ w.t()))
    return found


def phase_lstm_train_kernels():
    """The LSTM training kernels at the shapes of Config(cell_type="LSTM")'s
    step (LSTM(256) x 2 notes layers, instrument, velocity; the heads' cells)
    and Q, R at LSTM(512)'s, at B = 256 (timed, with bounds and cuDNN's LSTM
    beside L + N and matmul + Q + R) and B = 5, each against its plain
    version, with the training ops' gradients against autograd through the
    plain forward; then one LSTM(512) notes layer's forward + backward timed
    on both routes."""
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.rnn import init_decoder_states
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import lstm_layer as ll
    from midi_vae_tpu_torch.ops import lstm_step as ls
    from midi_vae_tpu_torch.ops.grad_reduce import (
        grad_reduce_reference,
        lstm_u_grad,
        lstm_weight_grads,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    tm = lambda a: a.transpose(0, 1).contiguous()  # noqa: E731
    results = {k: {} for k in ("lstm_layer_train_fwd", "lstm_layer_bwd", "lstm_layer_xp_fwd",
                               "lstm_layer_xp_bwd", "lstm_step", "grad_reduce_lstm",
                               "grad_reduce_lstm_wide", "lstm_fwd_bwd_vs_cudnn", *BPTT_PHASES,
                               "lstm_layer_xproj_train", "lstm_layer_fwd_chain_train")}
    flat = lambda outs: tuple(t for t in outs if t is not None)  # noqa: E731

    def plain_w(x, hprev, da, with_dw):
        n, G = x.shape[0] * x.shape[1], da.shape[-1]
        d2 = da.reshape(n, G)
        du = grad_reduce_reference(hprev.reshape(n, -1), d2)[0]
        return (*grad_reduce_reference(x.reshape(n, -1), d2, True), du) if with_dw else du

    def cublas_w(x, hprev, da, with_dw):
        n, G = x.shape[0] * x.shape[1], da.shape[-1]
        d2 = da.reshape(n, G)
        du = hprev.reshape(n, -1).t() @ d2
        return (x.reshape(n, -1).t() @ d2, d2.sum(0), du) if with_dw else du

    def layers(cfg, enc, batch, rows, wide):
        """(name, x, params, return_sequences, dx wanted) of the step's four
        encoder layers, notes L2's input the plain L1's h sequence."""
        h0 = torch.zeros(rows, cfg.lstm_size, device=dev)
        p1 = [enc["notes_rnn"][0][k].detach() for k in "wbu"]
        with torch.no_grad():
            x_l2 = ll.lstm_layer_reference(tm(batch["X"]), h0, h0, *p1, "tanh", True)
        return [("notes_l1", tm(batch["X"]), enc["notes_rnn"][0], True, False),
                ("notes_l2", x_l2, enc["notes_rnn"][1], False, True),
                ("instrument", tm(batch["I"]), enc["inst_rnn"][0], False, False),
                ("velocity", tm(batch["V"]), enc["vel_rnn"][0], False, False)]

    for rows in (B, RAGGED):
        timed = rows == B
        run = compare if timed else check
        # --- LSTM(256): L with c, N, W, and the gradients of L + N + W
        cfg = Config(cell_type="LSTM")
        model = MidiVAE(cfg).to(dev)
        enc, dec = model.params["encoder"], model.params["decoder"]
        batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, rows, 9).items()}
        h0 = torch.zeros(rows, cfg.lstm_size, device=dev)
        for name, x, p, rs, need_dx in layers(cfg, enc, batch, rows, False):
            w, b, u = (p[k].detach() for k in "wbu")
            T = x.shape[0]
            args = (x, h0, h0, w, b, u, "tanh", True, True)
            library = cudnn_lstm_layer(x, p, h0, h0) if timed else (None, None, None)
            out = run(f"L {name} x{tuple(x.shape)} with c", lambda a=args: ll.lstm_layer(*a),
                      lambda a=args: ll.lstm_layer_reference(*a), [L_H_ATOL, C_ATOL],
                      flops=layer_flops(T, rows, w, u), inputs=args[:6], library_fn=library[0])
            if timed:
                results["lstm_layer_train_fwd"][name] = out
            for phase, res in l_phase_checks(run, f"{name} with c", args).items():
                if timed:
                    results[f"{phase}_train"][name] = res
            with torch.no_grad():
                hseq, cseq = ll.lstm_layer_reference(*args)
            g = torch.randn(hseq.shape if rs else hseq.shape[1:], generator=gen, device=dev)
            bargs = (x, hseq, cseq, h0, h0, g if rs else None, None if rs else g, w, b, u, need_dx)
            out = run(f"N {name} rs={rs} dx={need_dx}",
                      lambda a=bargs: flat(ll.lstm_layer_bwd(*a)),
                      lambda a=bargs: flat(ll.lstm_layer_bwd_reference(*a)),
                      [rel] * (4 if need_dx else 3), flops=lstm_bwd_flops(T, rows, w, u, need_dx),
                      inputs=bargs[:10], library_fn=library[1])
            if timed:
                results["lstm_layer_bwd"][name] = out
            for phase, res in bptt_phase_checks(run, "N", f"{name} rs={rs}", bargs).items():
                if timed:
                    results[phase][name] = res
            da = ll.lstm_layer_bwd_reference(*bargs)[3]
            hprev = torch.cat([h0[None], hseq[:-1]])
            wargs = (x, hprev, da)
            out = run(f"W LSTM {name} dW, db, dU", lambda a=wargs: lstm_weight_grads(*a),
                      lambda a=wargs: plain_w(*a, True), [rel] * 3,
                      **tf32_work(2 * T * rows * (w.numel() + u.numel())), inputs=wargs,
                      library_fn=lambda a=wargs: cublas_w(*a, True))
            if timed:
                results["grad_reduce_lstm"][f"encoder {name}"] = out
                # L + N (+ W) against cuDNN's forward + backward, one layer
                leaves = [t.clone().requires_grad_(i > 0 or need_dx)
                          for i, t in enumerate((x, h0, h0, w, b, u))]

                def ours(lv=leaves, rs=rs, g=g):
                    want = [t for t in lv if t.requires_grad]
                    return torch.autograd.grad(ll.lstm_layer_train_x(*lv, rs), want, g)

                ours_ms, cudnn_ms = median_ms(ours), median_ms(library[2])
                results["lstm_fwd_bwd_vs_cudnn"][f"L+N+W {name}"] = {"ms": ours_ms,
                                                                      "cudnn_ms": cudnn_ms}
                print(f"[lstm train kernels] {name}: L + N + W forward + backward {ours_ms:.4f} ms, "
                      f"cuDNN's LSTM forward + backward {cudnn_ms:.4f} ms")
            leaves = [t.clone().requires_grad_(i > 0 or need_dx)
                      for i, t in enumerate((x, h0, h0, w, b, u))]
            wanted = [t for t in leaves if t.requires_grad]
            got = torch.autograd.grad(ll.lstm_layer_train_x(*leaves, rs), wanted, g)
            want = torch.autograd.grad(ll.lstm_layer_reference(*leaves, "tanh", rs), wanted, g)
            check(f"L+N+W grads {name} B={rows}", lambda: got, lambda: want, [rel] * len(want))
        # S on each head cell at the step's shapes: the input of layer 1 is
        # the fed-back probs (the start symbol's width), of layer 2 layer 1's h
        with torch.no_grad():
            z = model.encode(batch)
        new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
        for head, d, T in (("notes", cfg.output_dim, cfg.output_length),
                           ("velocity", 1, cfg.meta_velocity_length),
                           ("instrument", cfg.meta_instrument_dim, cfg.meta_instrument_length)):
            h = dec[head]
            states = init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                         cfg.lstm_state_activation)
            xin = torch.softmax(torch.randn(rows, d, generator=gen, device=dev), -1)
            for i, cell in enumerate(h["cells"]):
                w, b, u = (cell[k].detach() for k in "wbu")
                hs, cs = (s.detach() for s in states[i])
                args = (xin, hs, cs, w, b, u, "tanh")
                tag = f"{head} cell {i + 1}"
                out = run(f"S {tag} x{tuple(xin.shape)}", lambda a=args: ls.lstm_cell_step_fwd(*a),
                          lambda a=args: ls.lstm_cell_step_reference(*a), [L_H_ATOL, C_ATOL],
                          **tf32_work(2 * rows * (w.shape[0] + u.shape[0]) * u.shape[1]),
                          inputs=args[:6])
                if timed:
                    results["lstm_step"][tag] = head_loop_times(f"{tag} x{tuple(xin.shape)}",
                                                                out, args, T)
                leaves = [t.clone().requires_grad_() for t in args[:6]]
                gg = [torch.randn(rows, cfg.lstm_size, generator=gen, device=dev) for _ in range(2)]
                got = torch.autograd.grad(ls.lstm_cell_step(*leaves, "tanh"), leaves, gg)
                want = torch.autograd.grad(ls.lstm_cell_step_reference(*leaves, "tanh"), leaves, gg)
                check(f"S grads {tag} B={rows}", lambda: got, lambda: want, [rel] * 6)
                xin = ls.lstm_cell_step_reference(*args)[0]
        # --- LSTM(512), the wide route: Q, R and W (dU) over xp = x @ W + b
        cfg = Config(cell_type="LSTM", lstm_size=512)
        model = MidiVAE(cfg).to(dev)
        enc = model.params["encoder"]
        batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, rows, 10).items()}
        h0 = torch.zeros(rows, cfg.lstm_size, device=dev)
        for name, x, p, rs, _dx in layers(cfg, enc, batch, rows, True):
            w, b, u = (p[k].detach() for k in "wbu")
            T = x.shape[0]
            with torch.no_grad():
                xp = (x.reshape(T * rows, -1) @ w + b).reshape(T, rows, -1)
            library = cudnn_lstm_layer(xp, p, h0, h0, xp=True) if timed else (None, None, None)
            out = run(f"Q {name} xp{tuple(xp.shape)}", lambda: ll.lstm_layer_xp(xp, h0, h0, u),
                      lambda: ll.lstm_layer_xp_reference(xp, h0, h0, u), [H_ATOL, C_ATOL],
                      flops=2 * T * rows * u.numel(), inputs=[xp, h0, u], library_fn=library[0])
            if timed:
                results["lstm_layer_xp_fwd"][name] = out
            with torch.no_grad():
                hseq, cseq = ll.lstm_layer_xp_reference(xp, h0, h0, u)
            g = torch.randn(hseq.shape if rs else hseq.shape[1:], generator=gen, device=dev)
            bargs = (xp, hseq, cseq, h0, h0, g if rs else None, None if rs else g, u)
            # (dxp, dh0, dc0, da): in float32 da is dxp
            out = run(f"R {name} rs={rs}", lambda a=bargs: ll.lstm_layer_xp_bwd(*a),
                      lambda a=bargs: ll.lstm_layer_xp_bwd_reference(*a), [rel] * 4,
                      flops=4 * T * rows * u.numel(), inputs=bargs, library_fn=library[1])
            if timed:
                results["lstm_layer_xp_bwd"][name] = out
            for phase, res in bptt_phase_checks(run, "R", f"{name} rs={rs}", bargs).items():
                if timed:
                    results[phase][name] = res
            da = ll.lstm_layer_xp_bwd_reference(*bargs)[0]
            hprev = torch.cat([h0[None], hseq[:-1]])
            out = run(f"W LSTM(512) {name} dU", lambda: lstm_u_grad(hprev, da),
                      lambda: plain_w(x, hprev, da, False), [rel],
                      **tf32_work(2 * T * rows * u.numel()), inputs=[hprev, da],
                      library_fn=lambda: cublas_w(x, hprev, da, False))
            if timed:
                results["grad_reduce_lstm_wide"][f"encoder {name}"] = out
            leaves = [t.clone().requires_grad_() for t in (xp, h0, h0, u)]
            got = torch.autograd.grad(ll.lstm_layer_train(*leaves, rs), leaves, g)
            plain = ll.lstm_layer_xp_reference(*leaves)[0]
            want = torch.autograd.grad(plain if rs else plain[-1], leaves, g)
            check(f"Q+R+W grads {name} B={rows}", lambda: got, lambda: want, [rel] * 4)
            if not (timed and name.startswith("notes")):
                continue
            # one LSTM(512) notes layer's forward + backward on both routes,
            # beside cuDNN's forward + backward (the layer with its W)
            lv = [t.clone().requires_grad_(i > 0 or name == "notes_l2")
                  for i, t in enumerate((x, h0, h0, w, b, u))]
            wanted = [t for t in lv if t.requires_grad]

            def wide_route(lv=lv, wanted=wanted, rs=rs, g=g):
                xp_ = (lv[0].reshape(T * rows, -1) @ lv[3] + lv[4]).reshape(T, rows, -1)
                return torch.autograd.grad(ll.lstm_layer_train(xp_, lv[1], lv[2], lv[5], rs),
                                           wanted, g)

            def narrow_route(lv=lv, wanted=wanted, rs=rs, g=g):
                return torch.autograd.grad(ll.lstm_layer_train_x(*lv, rs), wanted, g)

            why = _layout.launch_limit("N", 512, 0)
            narrow_ms = median_ms(narrow_route) if why is None else None
            wide_ms = median_ms(wide_route)
            cudnn_ms = median_ms(cudnn_lstm_layer(x, p, h0, h0)[2])
            results["lstm_fwd_bwd_vs_cudnn"][f"512 {name}"] = {
                "wide_ms": wide_ms, "narrow_ms": narrow_ms, "cudnn_ms": cudnn_ms,
                "narrow_limit": why}
            narrow = f"{narrow_ms:.4f} ms" if why is None else f"does not launch ({why})"
            print(f"[lstm train kernels] LSTM(512) {name} forward + backward: wide route (matmul + "
                  f"Q + R + W) {wide_ms:.4f} ms, narrow route (L + N + W) {narrow}, cuDNN's LSTM "
                  f"{cudnn_ms:.4f} ms")
    # Q's forward chain at B = 512 (its clusters in more than one wave) and
    # at B = 300 (the last cluster ragged), on the LSTM(512) notes layers
    for rows in (2 * B, 300):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, rows, 11).items()}
        h0 = torch.zeros(rows, cfg.lstm_size, device=dev)
        for name, x, p, _rs, _dx in layers(cfg, enc, batch, rows, True)[:2]:
            w, b, u = (p[k].detach() for k in "wbu")
            with torch.no_grad():
                xp = (x.reshape(x.shape[0] * rows, -1) @ w + b).reshape(x.shape[0], rows, -1)
            plan = ll.fwd_chain_plan("Q", cfg.lstm_size, rows)
            check(f"Q {name} xp{tuple(xp.shape)}, {plan.clusters} clusters of {plan.rows} rows",
                  lambda: ll.lstm_layer_xp(xp, h0, h0, u),
                  lambda: ll.lstm_layer_xp_reference(xp, h0, h0, u), [H_ATOL, C_ATOL])
    print(f"[lstm train kernels] L with c, N, S, Q, R, W and the training ops' gradients also "
          f"agree at B = {RAGGED}; Q at B = {2 * B} and 300")
    return results


def classify_launches(kind_sizes, cell_type, epochs):
    """Launches of ClassifierTrainer.fit over ``epochs`` for judges of
    ``cell_type`` (2 layers each), ``kind_sizes`` {kind: (n_train, n_test)}:
    per train step the layers' training forward and backward with W (3 per
    GRU cell, 2 per LSTM cell), per evaluation batch the serving forward."""
    fwd, bwd, per_cell = (("gru_layer_fwd", "gru_layer_bwd", 3) if cell_type == "GRU"
                          else ("lstm_layer_fwd", "lstm_layer_bwd", 2))
    steps = sum(-(-n // 512) for n, _ in kind_sizes.values()) * epochs
    evals = sum(-(-n // 512) for _, n in kind_sizes.values()) * epochs
    want = {fwd: 2 * (steps + evals), bwd: 2 * steps, "grad_reduce": 2 * per_cell * steps}
    # N's and C's phases; dx for layer 2 alone
    prefix = "lstm_layer_bwd" if cell_type == "LSTM" else "gru_layer_bwd"
    # C's pre-pass launches twice a call (P1, P2), N's once
    want.update({f"{prefix}_gates": (4 if cell_type == "GRU" else 2) * steps,
                 f"{prefix}_chain": 2 * steps, f"{prefix}_dx": steps})
    return fwd_phases(want)


def phase_judge_training(work, smi):
    """The classify CLI trains GRU judges (RNN(256) x 2, batch 512) on an
    authored corpus for 2 epochs; ClassifierTrainer trains LSTM judges of all
    three kinds; one judge step per cell type, card against CPU; the
    transfer CLI serves the trained LSTM judges."""
    import io
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from midi_vae_tpu_torch import bridge
    from midi_vae_tpu_torch.cli import classify as classify_cli
    from midi_vae_tpu_torch.cli import transfer
    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.data.batching import flatten_dataset
    from midi_vae_tpu_torch.data.dataset import import_midi_from_folder
    from midi_vae_tpu_torch.models.classifier import (
        CLASSIFIER_KINDS,
        ClassifierSpec,
        StyleClassifier,
        classifier_loss,
    )
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.training.checkpoint import save_run
    from midi_vae_tpu_torch.training.classifier_trainer import ClassifierTrainer, classifier_arrays

    from midi_vae_tpu_torch.tools import make_demo_corpus as corpus

    rng = np.random.RandomState(3)
    source, cache = os.path.join(work, "corpus"), os.path.join(work, "cache")
    for style in ("style1", "style2"):
        os.makedirs(os.path.join(source, style))
        for i in range(10):
            corpus.make_song(corpus.STYLES[style], rng).write(os.path.join(source, style, f"{style}_{i}.mid"))
    cfg = Config(classes=("style1", "style2"))
    train, test, _, _ = flatten_dataset(import_midi_from_folder(source, cfg, cache_dir=cache), cfg)
    sizes = {k: (len(classifier_arrays(train, k)[1]), len(classifier_arrays(test, k)[1]))
             for k in CLASSIFIER_KINDS}
    paths, results = {}, {}

    def check_history(kind_dir, label):
        with open(os.path.join(kind_dir, "history.json")) as f:
            hist = json.load(f)
        losses = [e["loss"] for e in hist["train"]] + [e["loss"] for e in hist["test"]]
        if hist["epoch"] != [0, 1] or not np.all(np.isfinite(losses)):
            raise RuntimeError(f"{label}: history {hist['epoch']}, losses {losses}")
        return [round(x, 4) for x in losses]

    # 1. GRU judges through the classify CLI
    judges_gru = os.path.join(work, "judges_gru")
    reset_counters()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = classify_cli.main(["--source", source, "--output", judges_gru, "--classes",
                                "style1,style2", "--epochs", "2", "--cache", cache,
                                "--device", "cuda"])
    secs = time.perf_counter() - t0
    launches = read_counters()
    if rc != 0:
        raise RuntimeError(f"classify CLI returned {rc}:\n{buf.getvalue()}")
    want = classify_launches(sizes, "GRU", 2)
    if launches != want:
        raise RuntimeError(f"classify CLI: launch counters {launches}, expected {want}")
    losses = {k: check_history(os.path.join(judges_gru, k), f"GRU judge {k}")
              for k in CLASSIFIER_KINDS}
    paths["classify_gru"] = launches
    print(f"[judges] classify CLI, GRU(256) x 2 judges, batch 512, 2 epochs, samples (train, "
          f"test) {sizes}: {secs:.2f} s; losses {losses}; launches {launches} (as designed)")

    # 2. LSTM judges of all three kinds through ClassifierTrainer
    judges_lstm = os.path.join(work, "judges_lstm")
    lcfg = cfg.replace(cell_type="LSTM")
    reset_counters()
    t0 = time.perf_counter()
    for kind in CLASSIFIER_KINDS:
        trainer = ClassifierTrainer(ClassifierSpec.for_kind(kind, lcfg), "cuda")
        (tr_x, tr_c), (te_x, te_c) = classifier_arrays(train, kind), classifier_arrays(test, kind)
        trainer.fit(trainer.init_state(), tr_x, tr_c, te_x, te_c, epochs=2,
                    output_dir=os.path.join(judges_lstm, kind), log_fn=lambda m: None,
                    class_names=list(cfg.classes))
    secs = time.perf_counter() - t0
    launches = read_counters()
    want = classify_launches(sizes, "LSTM", 2)
    if launches != want:
        raise RuntimeError(f"LSTM judge training: launch counters {launches}, expected {want}")
    losses = {k: check_history(os.path.join(judges_lstm, k), f"LSTM judge {k}")
              for k in CLASSIFIER_KINDS}
    paths["classify_lstm"] = launches
    print(f"[judges] ClassifierTrainer, LSTM(256) x 2 judges of 3 kinds, 2 epochs: {secs:.2f} s; "
          f"losses {losses}; launches {launches} (as designed)")

    # 3. one judge training step per cell type, card against CPU, and its time
    for cell_type in ("GRU", "LSTM"):
        spec = ClassifierSpec.for_kind("pitch", cfg.replace(cell_type=cell_type))
        params = StyleClassifier(spec).init_params(np.array([0, 4], np.uint32))
        valid = 512 - 6
        drng = np.random.RandomState(11)
        x = np.eye(spec.input_dim, dtype=np.float32)[drng.randint(0, spec.input_dim, (512, 64))]
        c = np.eye(2, dtype=np.float32)[drng.randint(0, 2, 512)]
        x[valid:], c[valid:] = 0, 0
        mask = (np.arange(512) < valid).astype(np.float32)
        got = {}
        for device in ("cuda", "cpu"):
            model = StyleClassifier(spec, params, trainable=True).to(device)
            args = [torch.as_tensor(a, device=device) for a in (x, c, mask)]
            loss, metrics = classifier_loss(model, *args)
            named = list(model.params.named_parameters())
            grads = torch.autograd.grad(loss, [p for _, p in named])
            got[device] = (loss.item(), metrics["acc"].item(), [g.cpu() for g in grads],
                           [k for k, _ in named])
        (gl, ga, gg, names), (cl, ca, cg, _) = got["cuda"], got["cpu"]
        if not (abs(gl - cl) <= LOSS_ATOL and abs(ga - ca) <= ACC_ATOL):
            raise RuntimeError(f"{cell_type} judge step: loss {gl} / {cl}, acc {ga} / {ca}")
        worst = (0.0, "")
        for name, g, w in zip(names, gg, cg):
            limit = STEP_GRAD_RTOL * w.abs().max().item() + STEP_GRAD_ATOL
            err = (g - w).abs().max().item()
            if not (torch.isfinite(g).all() and err <= limit):
                raise RuntimeError(f"{cell_type} judge grad {name}: {err:.3e} > {limit:.3e}")
            worst = max(worst, (err / limit, name))
        trainer = ClassifierTrainer(spec, "cuda")
        state = trainer.new_state(params)
        dargs = [torch.as_tensor(a, device="cuda") for a in (x, c, mask)]
        for _ in range(3):
            trainer.train_step(state, *dargs)
        ms = median_ms(lambda: trainer.train_step(state, *dargs))
        results[cell_type] = {"step_ms": ms, "max_abs_dloss": abs(gl - cl),
                              "closest_grad_to_limit": worst[0]}
        print(f"[judges card vs cpu] {cell_type} pitch judge, one step at batch 512 ({valid} valid): "
              f"|dloss| {abs(gl - cl):.3e}, |dacc| {abs(ga - ca):.3e}; every gradient within limits "
              f"(closest: {worst[1]} at {worst[0]:.3f}); train step on the card {ms:.3f} ms "
              f"(median of {REPS}) on {smi}")

    # 4. the transfer CLI serves an LSTM run with the trained LSTM judges
    run = os.path.join(work, "lstm_run")
    save_run(run, lcfg, bridge.to_tree(MidiVAE(lcfg).params))
    song = os.path.join(source, "style1", "style1_0.mid")
    reset_counters()
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = transfer.main(["--model", run, "--input", song, "--to-class", "style2", "--output",
                            os.path.join(work, "out"), "--classifiers", judges_lstm,
                            "--device", "cuda"])
    launches = read_counters()
    judged = [line for line in buf.getvalue().splitlines() if "judge confidence" in line]
    want = fwd_phases({"lstm_layer_fwd": 4 + 2 * 6, "lstm_decode": 3})
    if rc != 0 or len(judged) != 2 or launches != want:
        raise RuntimeError(f"transfer with the trained LSTM judges: rc {rc}, launches {launches} "
                           f"(expected {want}), judge lines {judged}")
    paths["transfer_trained_lstm_judges"] = launches
    print("\n".join(f"[judges] {line}" for line in judged))
    print(f"[judges] the transfer CLI served the trained LSTM judges; launches {launches}")
    return paths, results


def phase_step_kernels():
    """The per-step cells at the shapes of the configs that run them, at B =
    256 (timed: each cell's loop in one window) and B = 5: T on each decode
    head cell of Config() and Config(lstm_size=512), the input of a head's
    first cell its fed-back output (the start symbol's width), of the second
    the first's h; T xp on each encoder layer's x-projection (notes L1, L2,
    instrument, velocity) at 256 and 512; S xp on each encoder layer's of
    Config(cell_type="LSTM") at 256 and 512, beside torch.lstm_cell over the
    same loop (its w_ih the identity, so that xp @ w_ih^T = xp: one 4H x 4H
    product more than S xp does). Then the three autograd Functions'
    gradients against autograd through the plain forward."""
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.rnn import init_decoder_states
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.ops import gru_layer as gl
    from midi_vae_tpu_torch.ops import gru_step as gs
    from midi_vae_tpu_torch.ops import lstm_layer as ll
    from midi_vae_tpu_torch.ops import lstm_step as ls

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    tm = lambda a: a.transpose(0, 1).contiguous()  # noqa: E731
    results = {k: {} for k in ("gru_step", "gru_step_512", "gru_step_xp", "gru_step_xp_512",
                               "lstm_step_xp", "lstm_step_xp_512")}

    def grads(tag, fn, plain, args, rows):
        leaves = [t.detach().clone().requires_grad_() for t in args]
        out = plain(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        cot = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
        got = torch.autograd.grad(fn(*leaves), leaves, cot)
        want = torch.autograd.grad(outs, leaves, cot)
        check(f"{tag} grads B={rows}", lambda: got, lambda: want, [rel] * len(want))

    def encoder_layers(cfg, enc, batch, rows, ref):
        """(name, x, params) of the four encoder layers, notes L2's input the
        plain L1's h sequence, all time-major."""
        h0 = torch.zeros(rows, cfg.lstm_size, device=dev)
        p1 = [enc["notes_rnn"][0][k] for k in "wbu"]
        x_l2 = ref(tm(batch["X"]), h0, *p1)
        return [("notes_l1", tm(batch["X"]), enc["notes_rnn"][0]),
                ("notes_l2", x_l2, enc["notes_rnn"][1]),
                ("instrument", tm(batch["I"]), enc["inst_rnn"][0]),
                ("velocity", tm(batch["V"]), enc["vel_rnn"][0])]

    for H in (256, 512):
        suffix = "" if H == 256 else "_512"
        gru_cfg, lstm_cfg = Config(lstm_size=H), Config(cell_type="LSTM", lstm_size=H)
        gru, lstm = MidiVAE(gru_cfg).to(dev), MidiVAE(lstm_cfg).to(dev)
        for rows in (B, RAGGED):
            timed = rows == B
            run = compare if timed else check
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in random_batch(gru_cfg, rows, 12).items()}
            with torch.no_grad():
                # --- T on each head cell
                z = gru.encode(batch)
                new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
                for head, d, T in (("notes", gru_cfg.output_dim, gru_cfg.output_length),
                                   ("velocity", 1, gru_cfg.meta_velocity_length),
                                   ("instrument", gru_cfg.meta_instrument_dim,
                                    gru_cfg.meta_instrument_length)):
                    h = gru.params["decoder"][head]
                    states = init_decoder_states(h["init"], new_encoded, "GRU",
                                                 gru_cfg.lstm_state_activation)
                    xin = torch.softmax(torch.randn(rows, d, generator=gen, device=dev), -1)
                    for i, cell in enumerate(h["cells"]):
                        args = (xin, states[i][0], cell["w"], cell["b"], cell["u"])
                        tag = f"H={H} {head} cell {i + 1}"
                        out = run(f"T {tag} x{tuple(xin.shape)}",
                                  lambda a=args: gs.gru_cell_step_fwd(*a),
                                  lambda a=args: gs.gru_cell_step_reference(*a), [H_ATOL],
                                  **t_work(rows, cell["w"].shape[0], H), inputs=args)
                        if timed:
                            results["gru_step" + suffix][f"{head} cell {i + 1}"] = loop_times(
                                f"T {tag}", out,
                                carried(lambda st, a=args: gs.gru_cell_step_fwd(
                                    a[0], st, *a[2:]), args[1], T),
                                carried(lambda st, a=args: gs.gru_cell_step_reference(
                                    a[0], st, *a[2:]), args[1], T), T)
                        with torch.enable_grad():
                            grads(f"T {tag}", lambda *a: gs.gru_cell_step(*a),
                                  gs.gru_cell_step_reference, args, rows)
                        xin = gs.gru_cell_step_reference(*args)
                # --- T xp on each encoder layer
                ref = lambda x, h0, w, b, u: gl.gru_layer_reference(x, h0, w, b, u, "tanh", True)  # noqa: E731
                for name, x, p in encoder_layers(gru_cfg, gru.params["encoder"], batch, rows, ref):
                    T = x.shape[0]
                    h0 = torch.zeros(rows, H, device=dev)
                    xp = (x.reshape(T * rows, -1) @ p["w"] + p["b"]).reshape(T, rows, 3 * H)
                    args = (xp[0], 0.5 * torch.tanh(torch.randn(rows, H, generator=gen,
                                                                device=dev)), p["u"])
                    tag = f"H={H} {name}"
                    out = run(f"T xp {tag} xp{tuple(xp.shape)}",
                              lambda a=args: gs.gru_recurrent_step_fwd(*a),
                              lambda a=args: gs.gru_recurrent_step_reference(*a), [H_ATOL],
                              **t_work(rows, 0, H), inputs=args)
                    if timed:
                        results["gru_step_xp" + suffix][name] = loop_times(
                            f"T xp {tag}", out,
                            carried(lambda st, x_t: gs.gru_recurrent_step_fwd(x_t, st, p["u"]),
                                    h0, T, xp),
                            carried(lambda st, x_t: gs.gru_recurrent_step_reference(
                                x_t, st, p["u"]), h0, T, xp), T)
                    if name == "notes_l2":
                        with torch.enable_grad():
                            grads(f"T xp {tag}", lambda *a: gs.gru_recurrent_step(*a),
                                  gs.gru_recurrent_step_reference, args, rows)
                # --- S xp on each LSTM encoder layer
                lbatch = {k: torch.as_tensor(v, device=dev)
                          for k, v in random_batch(lstm_cfg, rows, 13).items()}
                ref = lambda x, h0, w, b, u: ll.lstm_layer_reference(  # noqa: E731
                    x, h0, h0, w, b, u, "tanh", True)
                for name, x, p in encoder_layers(lstm_cfg, lstm.params["encoder"], lbatch, rows,
                                                 ref):
                    T = x.shape[0]
                    h0 = torch.zeros(rows, H, device=dev)
                    xp = (x.reshape(T * rows, -1) @ p["w"] + p["b"]).reshape(T, rows, 4 * H)
                    state = [0.5 * torch.tanh(torch.randn(rows, H, generator=gen, device=dev))
                             for _ in range(2)]
                    args = (xp[0], *state, p["u"])
                    tag = f"H={H} {name}"
                    out = run(f"S xp {tag} xp{tuple(xp.shape)}",
                              lambda a=args: ls.lstm_recurrent_step_fwd(*a),
                              lambda a=args: ls.lstm_recurrent_step_reference(*a),
                              [L_H_ATOL, C_ATOL], **tf32_work(2 * rows * p["u"].numel()),
                              inputs=args)
                    if timed:
                        eye, ut = torch.eye(4 * H, device=dev), p["u"].t().contiguous()
                        zero = torch.zeros(4 * H, device=dev)
                        check(f"torch.lstm_cell S xp {tag}",
                              lambda: torch.lstm_cell(args[0], tuple(state), eye, ut, zero, zero),
                              lambda: ls.lstm_recurrent_step_reference(*args), [H_ATOL, C_ATOL])
                        results["lstm_step_xp" + suffix][name] = loop_times(
                            f"S xp {tag}", out,
                            carried(lambda hc, x_t: ls.lstm_recurrent_step_fwd(x_t, *hc, p["u"]),
                                    (h0, h0), T, xp),
                            carried(lambda hc, x_t: ls.lstm_recurrent_step_reference(
                                x_t, *hc, p["u"]), (h0, h0), T, xp), T,
                            carried(lambda hc, x_t: torch.lstm_cell(x_t, hc, eye, ut, zero, zero),
                                    (h0, h0), T, xp))
                        results["lstm_step_xp" + suffix][name]["library_note"] = (
                            "torch.lstm_cell with w_ih = I (4H x 4H): one product more than S xp")
                    if name == "notes_l2":
                        with torch.enable_grad():
                            grads(f"S xp {tag}", lambda *a: ls.lstm_recurrent_step(*a),
                                  ls.lstm_recurrent_step_reference, args, rows)
    # T takes H a multiple of 32 up to 512: its plans also at the widths
    # whose clusters are not a power of two (3, 5, 6 and 7 CTAs of 64
    # units), float32, bf16 and T xp, at B = 256, one song's 16 and 5
    bf = torch.bfloat16
    for H in (192, 320, 384, 448):
        for rows in (B, 16, RAGGED):
            x = torch.softmax(torch.randn(rows, 61, generator=gen, device=dev), -1)
            h = 0.5 * torch.tanh(torch.randn(rows, H, generator=gen, device=dev))
            w = torch.randn(61, 3 * H, generator=gen, device=dev) / 61 ** 0.5
            b = 0.1 * torch.randn(3 * H, generator=gen, device=dev)
            u = torch.randn(H, 3 * H, generator=gen, device=dev) / H ** 0.5
            for dtype, limits in ((torch.float32, [H_ATOL]), (bf, [BF16_STEP])):
                args = tuple(t.to(dtype) for t in (x, h, w, b, u))
                check(f"T H={H} B={rows} {dtype}", lambda a=args: gs.gru_cell_step_fwd(*a),
                      lambda a=args: gs.gru_cell_step_reference(*a), limits)
            xp = torch.randn(rows, 3 * H, generator=gen, device=dev)
            check(f"T xp H={H} B={rows}", lambda: gs.gru_recurrent_step_fwd(xp, h, u),
                  lambda: gs.gru_recurrent_step_reference(xp, h, u), [H_ATOL])
    print(f"[step kernels] T, T xp and S xp at H = 256 and 512, and their gradients, also agree "
          f"at B = {RAGGED}; T, T bf16 and T xp at H = 192, 320, 384 and 448 (B = {B}, 16, "
          f"{RAGGED})")
    s_path_checks()
    return results


def s_path_checks():
    """S (float32 and bf16) and S xp against their plain versions at every
    shape the paths give them: H 256 and 512; B = 256, one song's 16 and
    RAGGED; the notes head's cell 1 (D = 61) and cell 2 (D = H), the
    velocity (D = 1) and instrument (D = 16) heads' cells; S xp on the same
    batches; the cell activations taken in turn (the serving heads that M
    does not take may use sigmoid or relu cells). Seeded inputs, a random
    state; float32 at S's limits (L_H_ATOL, C_ATOL), bf16 one step from
    that state at BF16_STEP."""
    import torch

    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import lstm_step as ls

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(21)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)  # noqa: E731
    acts = ("tanh", "sigmoid", "relu")
    n = 0
    for H in (256, 512):
        u = randn(H, 4 * H) / H ** 0.5
        for rows in (B, 16, RAGGED):
            h, c = 0.5 * torch.tanh(randn(rows, H)), randn(rows, H)
            for D in (61, H, 1, 16):
                x = torch.softmax(randn(rows, D), -1) if D != H else 0.5 * torch.tanh(randn(rows, D))
                w, b = randn(D, 4 * H) / D ** 0.5, 0.1 * randn(4 * H)
                for dtype, limits in ((torch.float32, [L_H_ATOL, C_ATOL]), (bf, [BF16_STEP] * 2)):
                    plan = _layout.step_plan(rows, D, H, 2 if dtype == bf else 4)
                    args = (*(t.to(dtype) for t in (x, h, c, w, b, u)), acts[n % 3])
                    check(f"S{' bf16' if dtype == bf else ''} H={H} B={rows} D={D} {args[-1]} "
                          f"(tile {plan.rows} x {plan.units})",
                          lambda a=args: ls.lstm_cell_step_fwd(*a),
                          lambda a=args: ls.lstm_cell_step_reference(*a), limits)
                    n += 1
            xp = randn(rows, 4 * H)
            for act in acts:
                args = (xp, h, c, u, act)
                check(f"S xp H={H} B={rows} {act}", lambda a=args: ls.lstm_recurrent_step_fwd(*a),
                      lambda a=args: ls.lstm_recurrent_step_reference(*a), [L_H_ATOL, C_ATOL])
                n += 1
    print(f"[step kernels] S, S bf16 and S xp agree with their plain versions at every path shape "
          f"(H 256 and 512; B {B}, 16, {RAGGED}; D 61, H, 1, 16): {n} checks")


def yardstick_bf16_lim(w):
    """The limit for ``torch.lstm_cell`` in bf16 against S's plain version:
    it rounds both products to bf16 before the gates, where S keeps them in
    float32, so it is held only to computing the same function: 1e-2 of the
    output's largest entry, at least 1e-2 (c grows past 1, where a bf16 step
    is 2**-7 or more)."""
    return 1e-2 * max(1.0, w.abs().max().item())


def phase_bf16_kernels():
    """Phase 26: X and Y over the encoder layers of the bf16 steps (notes L1
    with its h sequence, notes L2, instrument and velocity; xp = x @ W + b in
    one bf16 matmul and zero initial states, as models/rnn.py runs them) of
    GRU(256) and LSTM(256), X at row 27's (T 64, B 512, H 512) and Y at
    LSTM(512)'s B = 256 (row 33); T's and S's bf16 builds on each head cell
    of GRU(256) and LSTM(256) (each cell's loop in one window); all at
    B = 256 (timed, bound at the bf16 tensor-core rate) and B = 5, each
    against its plain bf16 version (BF16: max |diff| and relative L2; T bf16,
    one step from the model's state, BF16_STEP), with two wrong scans on
    notes L1 as controls that must fail BF16's relative L2 (``controls``)
    and, on each T bf16 cell, its plain phases with r * h rounded to bf16,
    which must fail BF16_STEP's (``rounded_rh``); the remat backward of X, Y, T and S against autograd
    through the JAX reference each differentiates."""
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.cells import get_cell
    from midi_vae_tpu_torch.models.rnn import init_decoder_states
    from midi_vae_tpu_torch.models.vae import MidiVAE, _cast_tree
    from midi_vae_tpu_torch.ops import encoder_scan as es
    from midi_vae_tpu_torch.ops import gru_step as gs
    from midi_vae_tpu_torch.ops import lstm_step as ls

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(6)
    tm = lambda a: a.transpose(0, 1).contiguous()  # noqa: E731
    results = {k: {} for k in ("gru_encoder_scan", "gru_encoder_scan_row27", "lstm_encoder_scan",
                               "lstm_encoder_scan_512", "gru_step_bf16", "lstm_step_bf16",
                               "gru_encoder_scan_block")}

    def grads(tag, fn, plain, args):
        leaves = [t.detach().clone().requires_grad_() for t in args]
        out = plain(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        cot = [torch.randn(o.shape, generator=gen, device=dev).to(o.dtype) for o in outs]
        got = torch.autograd.grad(fn(*leaves), leaves, cot)
        want = torch.autograd.grad(outs, leaves, cot)
        check(f"{tag} grads", lambda: got, lambda: want, [rel] * len(want))

    def model_of(cfg):
        model = MidiVAE(cfg).to(dev)
        return model, _cast_tree(model.params, bf)

    def scan_cases(cfg, params, rows, seed):
        """(name, xp, u, return_sequences) of the step's four encoder layers
        and the zero initial states, notes L2's input the plain L1's h
        sequence."""
        lstm = cfg.cell_type == "LSTM"
        enc = params["encoder"]
        batch = {k: torch.as_tensor(v, device=dev).to(bf)
                 for k, v in random_batch(cfg, rows, seed).items()}
        states = [torch.zeros(rows, cfg.lstm_size, device=dev, dtype=bf)
                  for _ in range(2 if lstm else 1)]
        plain = es.lstm_encoder_scan_reference if lstm else es.gru_encoder_scan_reference

        def xp_of(x, p):
            return (x.reshape(x.shape[0] * rows, -1) @ p["w"] + p["b"]).reshape(x.shape[0], rows, -1)

        with torch.no_grad():
            xp1 = xp_of(tm(batch["X"]), enc["notes_rnn"][0])
            seq1 = plain(xp1, *states, enc["notes_rnn"][0]["u"], "tanh", True)
            cases = [("notes_l1", xp1, enc["notes_rnn"][0]["u"], True),
                     ("notes_l2", xp_of(seq1, enc["notes_rnn"][1]), enc["notes_rnn"][1]["u"], False),
                     ("instrument", xp_of(tm(batch["I"]), enc["inst_rnn"][0]),
                      enc["inst_rnn"][0]["u"], False),
                     ("velocity", xp_of(tm(batch["V"]), enc["vel_rnn"][0]),
                      enc["vel_rnn"][0]["u"], False)]
        return [(n, xp, u.detach(), rs) for n, xp, u, rs in cases], states

    def scans(key, letter, cfg, rows, seed, only=None, library=False, timed=None,
              activation="tanh", limits=BF16):
        """X or Y on the step's encoder layers of ``cfg`` (``only``: those
        names) at ``rows`` with cell activation ``activation``; timed into
        results[key] (by default when rows == B)."""
        lstm = cfg.cell_type == "LSTM"
        _, params = model_of(cfg)
        fwd = es.lstm_encoder_scan_fwd if lstm else es.gru_encoder_scan_fwd
        plain = es.lstm_encoder_scan_reference if lstm else es.gru_encoder_scan_reference
        vjp_plain = es.lstm_encoder_scan_reference if lstm else es.gru_encoder_scan_vjp_reference
        timed = rows == B if timed is None else timed
        cases, states = scan_cases(cfg, params, rows, seed)
        for name, xp, u, rs in cases:
            if only and name not in only:
                continue
            args = (xp, *states, u, activation, rs)
            tag = f"{letter} {cfg.cell_type}({cfg.lstm_size}) {name} xp{tuple(xp.shape)} rs={rs}"
            if activation != "tanh":
                tag += f" {activation}"
            lib = None
            if timed and library:
                # cuDNN's LSTM in bf16 over xp (w_ih = I: one 4H x 4H product
                # more than Y does); a yardstick only, so a refusal leaves
                # library_ms null and fails nothing
                try:
                    lib = cudnn_lstm_layer(xp, {"u": u}, states[0], states[1], xp=True)[0]
                except RuntimeError as err:
                    print(f"[bf16 kernels] cuDNN's LSTM refused bf16 ({err}): no library time")
            # Y: its products on the tensor cores at the bf16 rate; X: x_work
            work = (x_work(xp.shape[0], rows, cfg.lstm_size) if not lstm else
                    {"flops": 2 * xp.shape[0] * rows * u.numel(), "peak": PEAK_BF16_FLOPS})
            if timed:
                results[key][name] = compare(
                    tag, lambda a=args: fwd(*a), lambda a=args: plain(*a), [BF16], **work,
                    inputs=args[:-2], library_fn=lib)
                if name == "notes_l1":
                    results[key][name]["controls_rel_l2"] = controls(tag, args)
                if name == "notes_l1" and key == "gru_encoder_scan":
                    # X's per-block route (its first design, the parent's) beside it
                    results["gru_encoder_scan_block"][name] = compare(
                        f"X per-block route {tag}", lambda a=args: es.gru_encoder_scan_block(*a),
                        lambda a=args: plain(*a), [BF16], **work, inputs=args[:-2])
            else:
                check(f"{tag} B={rows}", lambda a=args: fwd(*a), lambda a=args: plain(*a),
                      [limits])
            if name == "notes_l2" and activation == "tanh":
                scan = es.lstm_encoder_scan if lstm else es.gru_encoder_scan
                with torch.enable_grad():
                    grads(f"{letter} remat {name} B={rows}",
                          lambda *a, rs=rs: scan(*a, "tanh", rs),
                          lambda *a, rs=rs: vjp_plain(*a, "tanh", rs), args[:-2])

    def controls(tag, args):
        """Two faults against the plain scan: every op rounded to bf16 (the
        plain cells of ``models/cells.py`` scanned) and the state carried in
        float32 (the plain scan on float32 copies, only its output rounded).
        Each must land over BF16_REL_L2, or the limit does not tell a wrong
        kernel from X or Y."""
        xp, *states, u = args[:-2]
        lstm = len(states) == 2
        plain = es.lstm_encoder_scan_reference if lstm else es.gru_encoder_scan_reference
        cell = get_cell("LSTM" if lstm else "GRU")
        with torch.no_grad():
            want = plain(*args)
            st, per_op = tuple(states), []
            for x_t in xp:
                h, st = cell.step({"u": u}, x_t, st, torch.tanh)
                per_op.append(h)
            f32 = plain(xp.float(), *(s_.float() for s_ in states), u.float(), *args[-2:])
            found = {"per_op": rel_l2(torch.stack(per_op), want),
                     "float32_state": rel_l2(f32.to(want.dtype), want)}
        print(f"[bf16 kernels] controls {tag}: relative L2 from the plain scan, per-op bf16 "
              f"{found['per_op']:.3e}, float32 state {found['float32_state']:.3e} (each must "
              f"exceed {BF16_REL_L2:.1e})")
        for fault, err in found.items():
            if not err > BF16_REL_L2:
                raise RuntimeError(f"{tag}: the {fault} control lands {err:.3e} from the plain "
                                   f"scan, inside BF16_REL_L2 = {BF16_REL_L2:.1e}")
        return found

    def rounded_rh(tag, args):
        """A control: T bf16's plain phases with r * h rounded to bf16
        before P2 (the Pallas dot takes it in float32) must land over
        BF16_STEP_REL_L2 from the plain step, or the limit T bf16 is held to
        does not catch that fault."""
        with torch.no_grad():
            z, rh, cand = gs.gru_step_p1_reference(*args)
            ctl = gs.gru_step_p2_reference(z, rh.to(bf).float(), cand, args[1], args[4])
            err = rel_l2(ctl, gs.gru_cell_step_reference(*args))
        if not err > BF16_STEP_REL_L2:
            raise RuntimeError(f"{tag}: r * h rounded to bf16 lands {err:.3e} from the plain "
                               f"step, inside BF16_STEP_REL_L2 = {BF16_STEP_REL_L2:.1e}")
        print(f"[bf16 kernels] control {tag}: r * h rounded to bf16 lands {err:.3e} from the "
              f"plain step (must exceed {BF16_STEP_REL_L2:.1e})")

    def cells(key, cfg, rows, seed):
        """T's or S's bf16 build on each head cell of ``cfg``'s step: the input
        of a head's first cell its fed-back output (the start symbol's
        width), of the second the first's h."""
        lstm = cfg.cell_type == "LSTM"
        model, params = model_of(cfg)
        timed = rows == B
        run = compare if timed else check
        batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, rows, seed).items()}
        with torch.no_grad():
            z = model.encode(batch).to(bf)
        new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
        for head, d, T in (("notes", cfg.output_dim, cfg.output_length),
                           ("velocity", 1, cfg.meta_velocity_length),
                           ("instrument", cfg.meta_instrument_dim, cfg.meta_instrument_length)):
            h = params["decoder"][head]
            with torch.no_grad():
                states = init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                             cfg.lstm_state_activation)
            xin = torch.softmax(torch.randn(rows, d, generator=gen, device=dev), -1).to(bf)
            for i, cell in enumerate(h["cells"]):
                w, b, u = (cell[k].detach() for k in "wbu")
                st = [s.detach() for s in states[i]]
                tag = f"{cfg.cell_type}({cfg.lstm_size}) {head} cell {i + 1} x{tuple(xin.shape)}"
                flops = 2 * rows * (w.shape[0] + u.shape[0]) * u.shape[1]
                if lstm:
                    args = (xin, *st, w, b, u, "tanh")
                    out = run(f"S bf16 {tag}", lambda a=args: ls.lstm_cell_step_fwd(*a),
                              lambda a=args: ls.lstm_cell_step_reference(*a),
                              [BF16, BF16], flops=flops, inputs=args[:6],
                              peak=PEAK_BF16_FLOPS)
                    if timed:
                        results[key][f"{head} cell {i + 1}"] = head_loop_times(
                            tag, out, args, T, (yardstick_bf16_lim, yardstick_bf16_lim))
                    fn, plain, leaves = (ls.lstm_cell_step, ls.lstm_cell_step_vjp_reference,
                                         args[:6])
                    nxt = ls.lstm_cell_step_reference(*args)[0]
                else:
                    args = (xin, st[0], w, b, u)
                    out = run(f"T bf16 {tag}", lambda a=args: gs.gru_cell_step_fwd(*a),
                              lambda a=args: gs.gru_cell_step_reference(*a), [BF16_STEP],
                              **t_work(rows, w.shape[0], u.shape[0], True), inputs=args)
                    rounded_rh(f"T bf16 {tag} B={rows}", args)
                    if timed:
                        results[key][f"{head} cell {i + 1}"] = loop_times(
                            f"T bf16 {tag}", out,
                            carried(lambda s_, a=args: gs.gru_cell_step_fwd(a[0], s_, *a[2:]),
                                    args[1], T),
                            carried(lambda s_, a=args: gs.gru_cell_step_reference(a[0], s_, *a[2:]),
                                    args[1], T), T)
                    fn, plain, leaves = gs.gru_cell_step, gs.gru_cell_step_vjp_reference, args
                    nxt = gs.gru_cell_step_reference(*args)
                if head == "notes":
                    with torch.enable_grad():
                        grads(f"{'S' if lstm else 'T'} bf16 remat {tag} B={rows}",
                              lambda *a: fn(*a, "tanh"), lambda *a: plain(*a, "tanh"), leaves)
                xin = nxt

    slice_sets = {"compute_dtype": "bfloat16", "fused_train_encoder": False}
    gru256 = Config(fused_train_decoder=False, **slice_sets)
    lstm256 = Config(cell_type="LSTM", **slice_sets)
    for rows in (B, RAGGED):
        scans("gru_encoder_scan", "X", gru256, rows, 14)
        scans("lstm_encoder_scan", "Y", lstm256, rows, 15, library=True)
        cells("gru_step_bf16", gru256, rows, 16)
        cells("lstm_step_bf16", lstm256, rows, 17)
    # row 27: the batch-tiled TPU grid's shape, GRU(512) at B = 512 (the
    # notes layers); row 33: LSTM(512) at B = 256
    scans("gru_encoder_scan_row27", "X", Config(lstm_size=512, fused_train_decoder=False,
                                                **slice_sets), 512, 18, ("notes_l1", "notes_l2"),
          timed=True)
    lstm512 = Config(cell_type="LSTM", lstm_size=512, **slice_sets)
    scans("lstm_encoder_scan_512", "Y", lstm512, B, 19, library=True)
    # Y's forward chain at B = 512 (clusters in more than one wave at 512)
    # and with the other cell activations, the sequence (notes L1) and the
    # final h (notes L2); their outputs span more than tanh's, so they are
    # held to one bf16 step at their largest entry (BF16_OUT)
    for cfg in (lstm256, lstm512):
        scans("lstm_encoder_scan", "Y", cfg, 2 * B, 20, ("notes_l1", "notes_l2"), timed=False)
        for activation in ("sigmoid", "relu"):
            scans("lstm_encoder_scan", "Y", cfg, B, 21, ("notes_l1", "notes_l2"), timed=False,
                  activation=activation, limits=BF16_OUT)
    x_block_widths()
    print(f"[bf16 kernels] X, Y, T bf16 and S bf16 agree with their plain bf16 versions at "
          f"B = {B} and {RAGGED}, X at (64, 512, 512), Y at LSTM(512), at B = {2 * B} and with "
          f"sigmoid and relu cells; the remat backward too")
    return results


def x_block_widths():
    """X's chain with the other cell activations at B = 256 and row 27's B =
    512 (H = 256 and 512), and X's per-block route where the route chooser
    sends it (H = 160: A's bf16 chain takes H / C a multiple of 32 within
    half a block's shared memory), the sequence and the final h, tanh,
    sigmoid and relu, against the plain version; and that each ran on its
    route (X's counters)."""
    import torch

    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import encoder_scan as es

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(160)
    fn = es.gru_encoder_scan_fwd
    for H, rows_all, route in ((160, (16, RAGGED), "block"), (256, (B,), "chain"),
                               (512, (2 * B,), "chain")):
        assert _layout.gru_scan_route(H) == route
        before = (fn.launches_chain, fn.launches_block)
        n = 0
        for rows in rows_all:
            for act in ("tanh", "sigmoid", "relu"):
                for rs in (True, False):
                    randn = lambda *s_: torch.randn(*s_, generator=gen, device=dev)  # noqa: E731
                    xp = (0.5 * randn(16, rows, 3 * H)).to(bf)
                    h0 = torch.zeros(rows, H, device=dev, dtype=bf)
                    u = (randn(H, 3 * H) / H ** 0.5).to(bf)
                    args = (xp, h0, u, act, rs)
                    check(f"X {route} H={H} B={rows} {act} rs={rs}", lambda a=args: fn(*a),
                          lambda a=args: es.gru_encoder_scan_reference(*a), [BF16_OUT])
                    n += 1
        got = (fn.launches_chain - before[0], fn.launches_block - before[1])
        if got != ((n, 0) if route == "chain" else (0, n)):
            raise RuntimeError(f"X at H = {H} took its routes {got} times (chain, block), "
                               f"expected {n} on its {route}")
    print("[bf16 kernels] X's per-block route at H = 160 and its chain with every cell "
          "activation agree with their plain versions")


def flat_outputs(outs):
    """The tensors of nested outputs in order, Nones dropped."""
    import torch

    if isinstance(outs, torch.Tensor):
        return (outs,)
    return tuple(t for o in outs if o is not None for t in flat_outputs(o))


def bf16_step_lim(w):
    """One bf16 step at the largest entry of ``w``: the limit of an output
    rounded to bf16 once from float32 sums taken in another order (V's dx
    and dh0s, whose carries stay in float32)."""
    return 2.0 ** -7 * w.abs().max().item()


def phase_encoder_stacks():
    """Phase 29: kernels U (csrc/gru_encoder_stack_fwd.cu) and V
    (csrc/gru_encoder_stack_bwd.cu) of ops/encoder_stack.py at the default
    Config() encoder's full width, with its seeded weights: the multi-branch
    op (the notes stack over x (64, B, 61), the velocity branch (64, B, 1),
    the instrument branch (4, B, 16)) and stack2 from numpy-random h01 and
    h02, return_sequences both ways, each against its plain version at
    B = 256 (timed, with bounds) and B = 5; stack2 in bf16 (BF16, with two
    controls that feed layer 2 the rounded h1 and must land over
    BF16_REL_L2) and at H = 512 (each kernel launches, or raises
    LaunchLimitError exactly where ops/_layout.py says); both ops' gradients
    against autograd through the plain forward; and the same encoder through
    the per-layer route the model takes (A x 4; A x 4, C x 4 and W x 12)
    beside U and U + V + W, each way in CUDA-event windows."""
    import ctypes

    import numpy as np
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import encoder_stack as es
    from midi_vae_tpu_torch.ops import gru_layer as gl

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(29)
    rng = np.random.RandomState(29)
    tm = lambda a: a.transpose(0, 1).contiguous()  # noqa: E731
    wbu = lambda p: (p["w"], p["b"], p["u"])  # noqa: E731
    results = {k: {} for k in ("gru_encoder_stack_fwd", "gru_encoder_stack_bwd", "stack2_fwd",
                               "stack2_bwd", "stack2_bf16_fwd", "stack2_bf16_bwd", "stack2_512_fwd",
                               "stack2_512_bwd", "encoder_route")}

    def params_of(cfg):
        enc = MidiVAE(cfg).to(dev).params["encoder"]
        return [{k: p[k].detach() for k in "wbu"} for p in (
            enc["notes_rnn"][0], enc["notes_rnn"][1], enc["vel_rnn"][0], enc["inst_rnn"][0])]

    def state(rows, H, dtype=torch.float32):
        return torch.as_tensor(0.1 * rng.randn(rows, H), dtype=torch.float32, device=dev).to(dtype)

    def cot(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def stack2_fwd(key, name, args, run, limits, peak):
        x, p1, p2 = args[0], args[3], args[4]
        flops = layer_flops(x.shape[0], x.shape[1], p1["w"], p1["u"]) + layer_flops(
            x.shape[0], x.shape[1], p2["w"], p2["u"])
        out = run(f"U stack2 {name}", lambda: flat_outputs(es.gru_encoder_stack_fwd(*args)),
                  lambda: es.stack2_fwd_reference(*args), limits, flops=flops, inputs=args,
                  peak=peak)
        if key:
            results[key][name] = out

    def stack2_bwd(key, name, args, run, limits, peak):
        """V's stack2 entry from the plain forward's sequences and a random
        cotangent of layer 2's sequence (rs) or final h."""
        x, p1, p2, h01, h02, rs = args
        with torch.no_grad():
            h1, h2 = es.stack2_fwd_reference(x, h01, h02, p1, p2)
        g = cot(h2.shape if rs else h2.shape[1:], x.dtype)
        bargs = (x, h1, h2, h01, h02, g if rs else None, None if rs else g, p1, p2)
        T, rows = x.shape[:2]
        flops = cell_bwd_flops(T, rows, p1["w"], p1["u"]) + cell_bwd_flops(T, rows, p2["w"], p2["u"])
        out = run(f"V stack2 {name}", lambda: flat_outputs(es.gru_encoder_stack_bwd(*bargs)),
                  lambda: flat_outputs(es.stack2_bwd_reference(*bargs)), limits, flops=flops,
                  inputs=bargs, peak=peak)
        if key:
            results[key][name] = out
        return h2

    def stack2_controls(name, args, want):
        """Two scans that feed layer 2 the rounded h1 sequence: the two-layer
        JAX reference (``stack2_reference``: every op in bf16) and two plain
        layer scans with the kernels' rounding (kernel X's, once per layer).
        Each must land over BF16_REL_L2 from the plain stack, or the limit
        does not tell U from a kernel that rounds h1 before layer 2."""
        x, h01, h02, p1, p2 = args

        def layer_scan(xs, h, p):
            seq = []
            for x_t in xs:
                h = gl.gru_step(x_t, h, p["w"], p["u"], p["b"], torch.tanh)
                seq.append(h)
            return torch.stack(seq)

        with torch.no_grad():
            found = {"two_layer_reference": rel_l2(es.stack2_reference(x, h01, h02, p1, p2, "tanh",
                                                                       True), want),
                     "per_layer_scans": rel_l2(layer_scan(layer_scan(x, h01, p1), h02, p2), want)}
        print(f"[encoder stacks] controls U stack2 {name}: relative L2 from the plain stack, the "
              f"two-layer reference {found['two_layer_reference']:.3e}, the per-layer scans "
              f"{found['per_layer_scans']:.3e} (each must exceed {BF16_REL_L2:.1e})")
        for fault, err in found.items():
            if not err > BF16_REL_L2:
                raise RuntimeError(f"U stack2 {name}: the {fault} control lands {err:.3e} from the "
                                   f"plain stack, inside BF16_REL_L2 = {BF16_REL_L2:.1e}")
        return found

    cfg = Config()
    H = cfg.lstm_size
    p1, p2, pv, pi = params_of(cfg)
    bfp = lambda p: {k: v.to(bf) for k, v in p.items()}  # noqa: E731
    v_limits = [rel, rel, rel, rel, H_ATOL, rel, H_ATOL]  # dx, dh01, dh02, (da, r*h) x 2
    v_bf16_limits = [(bf16_step_lim, BF16_REL_L2)] * 3 + v_limits[3:]
    for rows in (B, RAGGED):
        timed = rows == B
        run = compare if timed else check
        batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, rows, 29).items()}
        x, xv, xi = tm(batch["X"]), tm(batch["V"]), tm(batch["I"])
        T = x.shape[0]
        branches = [(xv, pv), (xi, pi)]
        tag = f"x{tuple(x.shape)} + velocity {tuple(xv.shape)} + instrument {tuple(xi.shape)}"
        flops = sum(layer_flops(a.shape[0], rows, p["w"], p["u"])
                    for a, p in ((x, p1), (x, p2), (xv, pv), (xi, pi)))
        out = run(f"U multibranch {tag}",
                  lambda: flat_outputs(es.gru_encoder_stack_fwd(x, None, None, p1, p2, branches)),
                  lambda: flat_outputs(es.multibranch_fwd_reference(x, p1, p2, branches)),
                  [H_ATOL] * 4, flops=flops, inputs=(x, p1, p2, branches))
        if timed:
            results["gru_encoder_stack_fwd"]["multibranch"] = out
        with torch.no_grad():
            h1, h2, hk = es.multibranch_fwd_reference(x, p1, p2, branches)
        g2 = cot((rows, H))
        bb = [(xb, hb, cot((rows, H)), pb, False) for (xb, pb), hb in zip(branches, hk)]
        flops = (cell_bwd_flops(T, rows, p2["w"], p2["u"])
                 + cell_bwd_flops(T, rows, p1["w"], p1["u"], False)
                 + sum(cell_bwd_flops(xb.shape[0], rows, pb["w"], pb["u"], False)
                       for xb, pb in branches))
        out = run(f"V multibranch {tag}",
                  lambda: flat_outputs(es.gru_encoder_stack_bwd(x, h1, h2, None, None, None, g2, p1,
                                                                p2, bb, need_dx=False)),
                  lambda: flat_outputs(es.multibranch_bwd_reference(x, h1, h2, p1, p2, g2, bb,
                                                                    False)),
                  [rel, H_ATOL] * 4, flops=flops, inputs=(x, h1, h2, p1, p2, g2, bb))
        if timed:
            results["gru_encoder_stack_bwd"]["multibranch"] = out
        for rs in (False, True):
            name = f"x{tuple(x.shape)} rs={rs}" + ("" if timed else f" B={rows}")
            h0s = (state(rows, H), state(rows, H))
            stack2_fwd("stack2_fwd" if timed else None, name, (x, h0s[0], h0s[1], p1, p2), run,
                       [H_ATOL] * 2, PEAK_F32_FLOPS)
            stack2_bwd("stack2_bwd" if timed else None, name, (x, p1, p2, *h0s, rs), run, v_limits,
                       PEAK_F32_FLOPS)
            # bf16 (the JAX op's kernels run bf16 where D >= 8)
            xb, q1, q2 = x.to(bf), bfp(p1), bfp(p2)
            h0b = (state(rows, H, bf), state(rows, H, bf))
            args = (xb, h0b[0], h0b[1], q1, q2)
            stack2_fwd("stack2_bf16_fwd" if timed else None, name, args, run, [BF16] * 2,
                       PEAK_BF16_FLOPS)
            want = stack2_bwd("stack2_bf16_bwd" if timed else None, name, (xb, q1, q2, *h0b, rs),
                              run, v_bf16_limits, PEAK_BF16_FLOPS)
            if timed and not rs:
                found = stack2_controls(name, args, want)
                results["stack2_bf16_fwd"][name]["controls_rel_l2"] = found
        # both ops' gradients (U + V + W) against autograd through the plain forward
        with torch.enable_grad():
            for rs in (False, True):
                leaves = [t.clone().requires_grad_() for t in (x, state(rows, H), state(rows, H),
                                                             *wbu(p1), *wbu(p2))]
                q1, q2 = dict(zip("wbu", leaves[3:6])), dict(zip("wbu", leaves[6:9]))
                out = es.gru_stack2_train_x(*leaves[:3], q1, q2, "tanh", rs)
                g = cot(out.shape)
                got = torch.autograd.grad(out, leaves, g)
                ref = es.stack2_fwd_reference(*leaves[:3], q1, q2)[1]
                want = torch.autograd.grad(ref if rs else ref[-1], leaves, g)
                check(f"U+V+W stack2 grads rs={rs} B={rows}", lambda: got, lambda: want,
                      [rel] * len(want))
            leaves = [t.clone().requires_grad_() for t in (x, *wbu(p1), *wbu(p2), xv, *wbu(pv), xi,
                                                         *wbu(pi))]
            q = [dict(zip("wbu", leaves[i:i + 3])) for i in (1, 4, 8, 12)]
            h2f, finals = es.gru_encode_multibranch_train(
                {"x": leaves[0], "p1": q[0], "p2": q[1]},
                ({"x": leaves[7], "p": q[2]}, {"x": leaves[11], "p": q[3]}))
            gs = [cot(h2f.shape)] + [cot(f.shape) for f in finals]
            got = torch.autograd.grad((h2f, *finals), leaves, gs)
            _, r2, rk = es.multibranch_fwd_reference(leaves[0], q[0], q[1],
                                                     [(leaves[7], q[2]), (leaves[11], q[3])])
            want = torch.autograd.grad((r2[-1], *(h[-1] for h in rk)), leaves, gs)
            check(f"U+V+W multibranch grads B={rows}", lambda: got, lambda: want, [rel] * len(want))
    print(f"[encoder stacks] U and V agree with their plain versions at B = {B} and {RAGGED} "
          f"(multi-branch, stack2 in f32 and bf16), and both ops' gradients with autograd")

    # the same encoder through the per-layer route the model takes, at B
    batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, B, 30).items()}
    x, xv, xi = tm(batch["X"]), tm(batch["V"]), tm(batch["I"])
    h0 = torch.zeros(B, H, device=dev)
    branches = [(xv, pv), (xi, pi)]

    def fused_fwd():
        return flat_outputs(es.gru_encoder_stack_fwd(x, None, None, p1, p2, branches))

    def per_layer_fwd():
        s1 = gl.gru_layer(x, h0, *wbu(p1), "tanh", True)
        return (s1, *(gl.gru_layer(a, h0, *wbu(p), "tanh", True) for a, p in ((s1, p2), (xv, pv),
                                                                             (xi, pi))))

    leaves = [t.clone().requires_grad_() for p in (p1, p2, pv, pi) for t in wbu(p)]
    q = [dict(zip("wbu", leaves[3 * i:3 * i + 3])) for i in range(4)]
    gs = [cot((B, H)) for _ in range(3)]

    def fused_fwd_bwd():
        with torch.enable_grad():
            h2f, finals = es.gru_encode_multibranch_train(
                {"x": x, "p1": q[0], "p2": q[1]}, ({"x": xv, "p": q[2]}, {"x": xi, "p": q[3]}))
            return torch.autograd.grad((h2f, *finals), leaves, gs)

    def per_layer_fwd_bwd():
        with torch.enable_grad():
            s1 = gl.gru_layer_train_x(x, h0, *wbu(q[0]), True)
            outs = [gl.gru_layer_train_x(a, h0, *wbu(p), False)
                    for a, p in ((s1, q[1]), (xv, q[2]), (xi, q[3]))]
            return torch.autograd.grad(outs, leaves, gs)

    check("encoder forward: U against A x 4", fused_fwd, per_layer_fwd, [H_ATOL] * 4)
    check("encoder forward + backward: U + V + W against A + C + W", fused_fwd_bwd,
          per_layer_fwd_bwd, [rel] * len(leaves))
    route = results["encoder_route"]
    for key, fn in (("per_layer_fwd_ms", per_layer_fwd), ("fused_fwd_ms", fused_fwd),
                    ("fused_fwd_ms_2", fused_fwd), ("per_layer_fwd_ms_2", per_layer_fwd),
                    ("per_layer_fwd_bwd_ms", per_layer_fwd_bwd),
                    ("fused_fwd_bwd_ms", fused_fwd_bwd),
                    ("fused_fwd_bwd_ms_2", fused_fwd_bwd),
                    ("per_layer_fwd_bwd_ms_2", per_layer_fwd_bwd)):
        route[key.removesuffix("_2")] = route.get(key.removesuffix("_2"), 0.0) + median_ms(fn) / 2
    print(f"[encoder stacks] Config() encoder at B = {B}: forward U {route['fused_fwd_ms']:.4f} ms "
          f"(1 launch) against A x 4 {route['per_layer_fwd_ms']:.4f} ms; forward + backward "
          f"U + V + "
          f"W {route['fused_fwd_bwd_ms']:.4f} ms (1 + 1 + 12 launches) against A + C + W "
          f"{route['per_layer_fwd_bwd_ms']:.4f} ms (4 + 4 + 12)")

    # H = 512 (vae_wide's width): each kernel launches, or raises exactly
    # where the route chooser's table says
    q1, q2 = params_of(Config(lstm_size=512))[:2]
    x = tm(torch.as_tensor(random_batch(cfg, B, 31)["X"], device=dev))
    h0s = (state(B, 512), state(B, 512))
    name = f"H=512 x{tuple(x.shape)} rs=False"
    for letter, smem, run_it in (
            ("U", _layout.smem_bytes("U", 512, x.shape[2], 2),
             lambda: stack2_fwd("stack2_512_fwd", name, (x, *h0s, q1, q2), compare, [H_ATOL] * 2,
                                PEAK_F32_FLOPS)),
            ("V", _layout.smem_bytes("V", 512, x.shape[2], 2, True),
             lambda: stack2_bwd("stack2_512_bwd", name, (x, q1, q2, *h0s, False), compare, v_limits,
                                PEAK_F32_FLOPS))):
        why = _layout.launch_limit(letter, 512, smem)
        if why is None:
            run_it()
            continue
        try:
            run_it()
        except _layout.LaunchLimitError as err:
            if str(err) != why:
                raise RuntimeError(f"{letter} at H = 512 raised {err!r}, the table says {why!r}")
        else:
            raise RuntimeError(f"{letter} at H = 512 ran where the route chooser says: {why}")
        # and the build itself refuses 512 threads at its C entry point
        # (cudaErrorLaunchOutOfResources, before any memory is touched)
        lib, _, multibranch = es._kernels(f"gru_encoder_stack_{'fwd' if letter == 'U' else 'bwd'}")
        stack = (es._StackFwd if letter == "U" else es._StackBwd)(T=64, D=x.shape[2])
        rc = multibranch(ctypes.byref(stack), None, 0, B, 512, None)
        if rc != 701:
            raise RuntimeError(f"{letter}'s C entry point at H = 512 returned {rc}, not 701 "
                               f"(cudaErrorLaunchOutOfResources)")
        print(f"[encoder stacks] {letter} at H = 512 raises LaunchLimitError, as the table says, and "
              f"its build refuses 512 threads: {why}")
    return results


# bf16 with the default flags (phases 30-32). A's bf16 h sequences are held
# to BF16 as X's are. The bf16 outputs of D and the bf16 gradients of C
# and E (dx, dh0, d_init, d_start) span up to several units, where one bf16
# step is larger than BF16_ATOL: they are held to one bf16 step at their
# largest entry and to BF16_REL_L2 (BF16_OUT). The autograd ops' gradients
# against the plain backward (the weight grads rounded to bf16 from float32
# sums over forward sequences that themselves differ by rounding flips) to
# two bf16 steps at their largest entry and BF16_GRAD_REL_L2_OP. Over 64
# steps a state entry that rounds the other way carries on, so a wrong
# rounding that moves each step by less than a bf16 step hides in that
# spread: on the H100 (NVIDIA H100 80GB HBM3, 700 W) the kernels' relative
# L2 from their plain versions reached 5.6e-4 (A), 6.3e-4 (D's logits) and
# 1.35e-3 (the ops' gradients), where r * h rounded to bf16 in A landed at
# 1.5e-3 and layer 2 fed the rounded h1 in D at 3.4e-4. So the controls
# are run on one step from a random state, where a sound kernel differs from
# its plain version only where a float32 sum taken in another order
# straddles a bf16 rounding boundary: A and D at T = 1 are held to
# BF16_STEP_REL_L2, and each control must land over it. W's sums stay
# float32 in both versions (bf16 activations widened, float32 gate grads):
# max |diff| to rel() and relative L2 to W_REL_L2 (the kernel: 9.3e-7), which
# a W that rounds the gate grads to bf16 before summing them (1.3e-3) must
# exceed
BF16_OUT = (bf16_step_lim, BF16_REL_L2)
BF16_GRAD_REL_L2_OP = 4e-3
BF16_GRAD_OP = (lambda w: 2 * bf16_step_lim(w), BF16_GRAD_REL_L2_OP)
BF16_STEP_REL_L2 = 1e-4
BF16_STEP = (bf16_step_lim, BF16_STEP_REL_L2)
W_REL_L2 = 1e-5
# the gate-grad streams of the wide route in bf16 (phase 33), against their
# plain versions on the same forward sequences: G's float32 gate grads (dU's
# operand) and E wide's dlogits and gate grads, which hold bf16 values (row
# 14's pass 2 sums them rounded). A sound kernel differs from its plain
# version where a float32 sum taken in another order straddles a bf16
# rounding boundary: on the H100 (NVIDIA H100 80GB HBM3, 700 W) E wide's
# streams read at most 6.9e-5. A stream left unrounded, or G's rounded, is
# off by up to half a bf16 step in every entry (about 1e-3), and the
# controls of check_wide_controls must land over the limit
STREAM_REL_L2 = 2e-4
# E's bf16-residual build (phase 39) against its plain version over the same
# rounded h sequences: float32 on both sides, sums in another order, so each
# gradient is held to rel() and to RESID_REL_L2 relative L2 (on the H100,
# NVIDIA H100 80GB HBM3, 700 W: at most 8.2e-7). E's float32 build fed the
# unrounded sequences, each h entry off by up to half a bf16 step, must land
# over one of the two (there: 2.7 and 3.8 times them)
RESID_REL_L2 = 1e-5


def layer_flops_bf16(T, B, w, u):
    """(bf16 x bf16, float32-rate) operations of A's bf16 build: x @ W and
    h @ U[:, :2H] are bf16 products, (r * h) @ U[:, 2H:] takes the float32
    r * h."""
    H = u.shape[0]
    return 2 * T * B * (w.shape[0] * 3 * H + H * 2 * H), 2 * T * B * H * H


def plain_layer_vjp(x, h0, w, b, u, rs, g):
    """The gradients of ``gru_layer_train_x`` through the plain versions of
    A, C and W (the CPU path's explicit float32 transposition), cast as the
    autograd op casts them: (dx, dh0, dW, db, dU)."""
    import torch

    from midi_vae_tpu_torch.ops import gru_layer as gl

    seq = gl.gru_layer_reference(x, h0, w, b, u, "tanh", True)
    dx, dh0, da, rh = gl.gru_layer_bwd_reference(x, seq, h0, g if rs else None,
                                                 None if rs else g, w, b, u)
    dw, db, du = plain_weight_grads(x, torch.cat([h0[None], seq[:-1]]), rh, da)
    return dx, dh0, dw.to(w.dtype), db.to(b.dtype), du.to(u.dtype)


def plain_decode_vjp(head, g_probs, g_logits, wide=False, fwd=None):
    """The gradients of one head's training decode through the plain versions
    of D (or over ``fwd``, the (probs, h sequences) a kernel stored), E
    (``wide``: E's wide build, its streams rounded) and W, in
    ``_flatten_head`` order, cast to the inputs' dtypes."""
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops.grad_reduce import grad_reduce_reference

    h = head
    probs, h_seqs = fwd or gd.gru_decode_train_reference(
        h["cells"], h["out"], h["init"], h["start"], h["T"], h["out_activation"])[::2]
    g = gd.gru_decode_bwd_reference(h["cells"], h["out"], h["init"], h["start"], probs, h_seqs,
                                    g_probs, g_logits, h["out_activation"], wide)
    T, (rows, D), H = h["T"], h["start"].shape, h["init"][0].shape[-1]
    dwo, dbo = grad_reduce_reference(h_seqs[-1].reshape(T * rows, H),
                                     g["dlogits"].reshape(T * rows, D), True)
    cells = []
    for i in range(len(h["cells"])):
        x = h_seqs[i - 1] if i > 0 else torch.cat([h["start"][None], probs[:-1]])
        hprev = torch.cat([h["init"][i][None], h_seqs[i][:-1]])
        dw, db, du = plain_weight_grads(x, hprev, g["rh"][i], g["da"][i])
        cells += [dw, du, db]
    flat = [g["d_start"], *g["d_init"], *cells, dwo, dbo]
    return tuple(t.to(p.dtype) for t, p in zip(flat, gd._flatten_head(h)))


def scan_rounding_rh(x, h0, w, b, u):
    """A control: A's plain version with r * h rounded to bf16 before its
    product with U[:, 2H:] (the Pallas kernel keeps it float32)."""
    import torch

    H = h0.shape[-1]
    xp, uf, h, seq = x.float() @ w.float() + b.float(), u.float(), h0, []
    for t in range(x.shape[0]):
        hf = h.float()
        hu = hf @ uf[:, : 2 * H]
        z = torch.sigmoid(xp[t, :, :H] + hu[:, :H])
        r = torch.sigmoid(xp[t, :, H : 2 * H] + hu[:, H:])
        hh = torch.tanh(xp[t, :, 2 * H :] + (r * hf).to(h.dtype).float() @ uf[:, 2 * H :])
        h = (z * hf + (1.0 - z) * hh).to(h.dtype)
        seq.append(h)
    return torch.stack(seq)


def decode_rounding_h1(head):
    """A control: D's plain version with layer 2 fed the rounded h1 (the
    Pallas kernel feeds it the float32 h1 of the step): its (probs, top h
    sequence)."""
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops.gru_layer import gru_step

    act = gd.out_activation_fn(head["out_activation"])
    states, x, probs, top = list(head["init"]), head["start"], [], []
    for _ in range(head["T"]):
        for i, p in enumerate(head["cells"]):
            x = states[i] = gru_step(x, states[i], p["w"], p["u"], p["b"], torch.tanh)
        top.append(x)
        x = act(x.float() @ head["out"]["w"].float() + head["out"]["b"].float()).to(x.dtype)
        probs.append(x)
    return torch.stack(probs), torch.stack(top)


def phase_bf16_fused_kernels():
    """Phase 30: the bf16 builds of A (csrc/gru_layer_fwd.cu), C
    (csrc/gru_layer_bwd.cu), W (csrc/grad_reduce.cu), D
    (csrc/gru_decode_train.cu) and E (csrc/gru_decode_bwd.cu) at the bf16
    Config() step's shapes (the four encoder layers with the h sequence;
    the notes head, 2 layers, softmax, D = 61, and the instrument head, 1
    layer, softmax, D = 16, 4 steps, each decoded alone; W over each layer's
    and head's products), the params and batch cast to bf16 as the model
    casts them, each against its plain bf16 version at B = 256 (timed, with
    bounds: bf16 x bf16 products at the bf16 rate, the rest at the float32
    rate; W beside cuBLAS's a.t() @ b on the widened operands) and B = 5;
    three wrong plain versions as controls that must land over the limits
    (``controls``); the autograd ops' gradients (gru_layer_train_x,
    gru_decode_train) against the plain backward (the float32 transposition
    through the plain versions of C, E and W)."""
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.rnn import init_decoder_states
    from midi_vae_tpu_torch.models.vae import MidiVAE, _cast_tree
    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops import gru_layer as gl
    from midi_vae_tpu_torch.ops.grad_reduce import (
        grad_reduce,
        grad_reduce_reference,
        gru_weight_grads,
    )

    cfg = Config(compute_dtype="bfloat16")
    dev, bf = torch.device("cuda"), torch.bfloat16
    model = MidiVAE(cfg).to(dev)
    params = _cast_tree(model.params, bf)
    enc, dec = params["encoder"], params["decoder"]
    gen = torch.Generator(device=dev).manual_seed(30)
    tm = lambda a: a.transpose(0, 1).contiguous()  # noqa: E731
    flat = lambda outs: tuple(t for t in outs if t is not None)  # noqa: E731
    keys = ("gru_layer_fwd_bf16", "gru_layer_bwd_bf16", "grad_reduce_bf16",
            "gru_decode_train_bf16", "gru_decode_train_chain_bf16",
            "gru_decode_train_block_bf16", "gru_decode_bwd_bf16",
            *(f"{k}_bf16" for k in (*A_PHASES, *C_PHASES, *E_PHASES)))
    results = {k: {} for k in keys}
    found = {}

    def cot(shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def widened(*ts):
        return tuple(t.float() for t in ts)

    def kernel_d(head):
        """D's outputs for one head: probs, logits, then each layer's h."""
        probs, logits, h_seqs = gd.gru_decode_fwd_train([head])[0]
        return probs, logits, *h_seqs

    def plain_d(head):
        probs, logits, h_seqs = gd.gru_decode_train_reference(
            head["cells"], head["out"], head["init"], head["start"], head["T"],
            head["out_activation"])
        return probs, logits, *h_seqs

    for rows in (B, RAGGED):
        timed = rows == B
        run = compare if timed else check
        batch = {k: torch.as_tensor(v, device=dev).to(bf)
                 for k, v in random_batch(cfg, rows, 30).items()}
        h0 = torch.zeros(rows, cfg.lstm_size, device=dev, dtype=bf)
        with torch.no_grad():
            x_l2 = gl.gru_layer_reference(tm(batch["X"]), h0,
                                          *(enc["notes_rnn"][0][k] for k in "wbu"), "tanh", True)
        layer_cases = [  # name, x, params, return_sequences, dx wanted
            ("notes_l1", tm(batch["X"]), enc["notes_rnn"][0], True, False),
            ("notes_l2", x_l2, enc["notes_rnn"][1], False, True),
            ("instrument", tm(batch["I"]), enc["inst_rnn"][0], False, False),
            ("velocity", tm(batch["V"]), enc["vel_rnn"][0], False, False),
        ]
        for name, x, p, rs, need_dx in layer_cases:
            w, b, u = (p[k].detach() for k in "wbu")
            T = x.shape[0]
            args = (x, h0, w, b, u, "tanh", True)
            fb, ff = layer_flops_bf16(T, rows, w, u)
            out = run(f"A bf16 {name} x{tuple(x.shape)}", lambda a=args: gl.gru_layer(*a),
                      lambda a=args: gl.gru_layer_reference(*a), [BF16], flops=fb, flops_f32=ff,
                      inputs=args[:5], peak=PEAK_BF16_FLOPS)
            for phase, res in a_phase_checks(run, name, args, BF16).items():
                if timed:
                    results[phase][name] = res
            with torch.no_grad():
                seq = gl.gru_layer_reference(*args)
            if timed:
                results["gru_layer_fwd_bf16"][name] = out
            if timed and name == "notes_l1":
                # one step from a random state: the control's ground
                state = (0.5 * torch.tanh(torch.randn(rows, cfg.lstm_size, generator=gen,
                                                      device=dev))).to(bf)
                sargs = (x[:1].contiguous(), state, w, b, u, "tanh", True)
                found["A one step (the kernel)"] = _check(
                    f"A bf16 {name} one step", lambda a=sargs: gl.gru_layer(*a),
                    lambda a=sargs: gl.gru_layer_reference(*a), [BF16_STEP])[1][0]
                found["A: r*h rounded"] = rel_l2(scan_rounding_rh(*sargs[:5]),
                                                 gl.gru_layer_reference(*sargs))
            g = cot(seq.shape if rs else seq.shape[1:])
            cargs = (x, seq, h0, g if rs else None, None if rs else g, w, b, u, need_dx)
            # dx, dh0 (bf16 grads), da_cat (float32 grads), r*h (a float32 value)
            limits = ([BF16_OUT] if need_dx else []) + [BF16_OUT, rel, H_ATOL]
            out = run(f"C bf16 {name} rs={rs}", lambda a=cargs: flat(gl.gru_layer_bwd(*a)),
                      lambda a=cargs: flat(gl.gru_layer_bwd_reference(*a)), limits,
                      **c_work(x, u, need_dx), inputs=cargs[:8])
            if timed:
                results["gru_layer_bwd_bf16"][name] = out
            for phase, res in c_phase_checks(run, f"{name} rs={rs} B={rows}", cargs).items():
                if timed:
                    results[phase][name] = res
            _dx, _dh0, da, rh = gl.gru_layer_bwd_reference(*cargs)
            wargs = (x, torch.cat([h0[None], seq[:-1]]), rh, da)
            wide = widened(*wargs)
            out = run(f"W bf16 {name} dW, db, dU", lambda a=wargs: gru_weight_grads(*a),
                      lambda a=wargs: plain_weight_grads(*a), [(rel, W_REL_L2)] * 3,
                      **tf32_work(weight_grad_flops(x, wargs[1]), 2), inputs=wargs,
                      library_fn=lambda a=wide: cublas_weight_grads(*a))
            if timed:
                results["grad_reduce_bf16"][f"encoder {name}"] = out
                if name == "notes_l1":
                    want = plain_weight_grads(*wargs)
                    rounded = plain_weight_grads(x, wargs[1], rh, da.to(bf).float())
                    found["W: gate grads rounded"] = min(
                        rel_l2(r_, w_) for r_, w_ in zip(rounded, want) if r_.numel() > 3 * 256)
            # A + C + W against the plain backward
            leaves = [t.clone().requires_grad_(i > 0 or need_dx) for i, t in enumerate((x, h0, w, b, u))]
            wanted = [t for t in leaves if t.requires_grad]
            got = torch.autograd.grad(gl.gru_layer_train_x(*leaves, rs), wanted, g)
            want = [t for t, leaf in zip(plain_layer_vjp(x, h0, w, b, u, rs, g), leaves)
                    if leaf.requires_grad]
            check(f"A+C+W bf16 grads {name} B={rows}", lambda: got, lambda: tuple(want),
                  [BF16_GRAD_OP] * len(want))

        with torch.no_grad():
            z = model.encode({k: v.float() for k, v in batch.items()}).to(bf)
        new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
        for name, d, T, out_act in (("notes", cfg.output_dim, cfg.output_length, cfg.activation),
                                    ("instrument", cfg.meta_instrument_dim,
                                     cfg.meta_instrument_length, cfg.meta_instrument_activation)):
            h = dec[name]
            with torch.no_grad():
                states = init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                             cfg.lstm_state_activation)
            head = {"cells": [{k: c[k].detach() for k in "wub"} for c in h["cells"]],
                    "out": {k: h["out"][k].detach() for k in "wb"},
                    "init": [s_[0].detach() for s_ in states],
                    "start": torch.zeros(rows, d, device=dev, dtype=bf), "T": T,
                    "out_activation": out_act}
            n = len(head["cells"])
            tag = f"{name} ({n}L D={d} T={T} {out_act})"
            dinputs = [head["cells"], head["out"], head["init"], head["start"]]
            out = run(f"D bf16 {tag}", lambda h_=head: kernel_d(h_), lambda h_=head: plain_d(h_),
                      [BF16_OUT] * (2 + n), **d_work([head]), inputs=dinputs)
            # its per-block route (the first design, 8 rows a block) on the
            # same head, a width it still serves
            blk = run(f"D bf16 per-block route {tag}", lambda h_=head: tuple(
                t for p_, l_, hs_ in d_block([h_], "D_bf16") for t in (p_, l_, *hs_)),
                lambda h_=head: plain_d(h_), [BF16_OUT] * (2 + n), **d_work([head]),
                inputs=dinputs)
            probs, _logits, *h_seqs = plain_d(head)
            if timed:
                results["gru_decode_train_bf16"][name] = out
                results["gru_decode_train_chain_bf16"][name] = out
                results["gru_decode_train_block_bf16"][name] = blk
            if timed and n == 2:
                # one step from the head's initial states: the control's ground
                step1 = dict(head, T=1)
                found["D one step (the kernel)"] = max(_check(
                    f"D bf16 {name} one step", lambda h_=step1: kernel_d(h_),
                    lambda h_=step1: plain_d(h_), [BF16_STEP] * (2 + n))[1])
                want1 = plain_d(step1)
                wrong = decode_rounding_h1(step1)
                found["D: layer 2 fed the rounded h1"] = max(rel_l2(wrong[0], want1[0]),
                                                             rel_l2(wrong[1], want1[-1]))
            head.update(probs=probs, h_seqs=h_seqs, g_probs=cot(probs.shape),
                        g_logits=cot(probs.shape))
            bwd_flat = lambda o: (o["dlogits"], *o["da"], *o["rh"], *o["d_init"], o["d_start"])  # noqa: E731
            out = run(f"E bf16 {tag}", lambda h_=head: bwd_flat(gd.gru_decode_bwd([h_])[0]),
                      lambda h_=head: bwd_flat(gd.gru_decode_bwd_reference(
                          h_["cells"], h_["out"], h_["init"], h_["start"], h_["probs"],
                          h_["h_seqs"], h_["g_probs"], h_["g_logits"], h_["out_activation"])),
                      [rel] * (1 + n) + [H_ATOL] * n + [BF16_OUT] * (n + 1),
                      **e_work([head]),
                      inputs=[head[k] for k in ("cells", "out", "init", "start", "probs",
                                                "h_seqs", "g_probs", "g_logits")])
            if timed:
                results["gru_decode_bwd_bf16"][name] = out
            for phase, res in e_phase_checks(run, f"{tag}", [head], "E_bf16").items():
                if timed:
                    results[phase][name] = res
            g = gd.gru_decode_bwd_reference(head["cells"], head["out"], head["init"], head["start"],
                                            probs, h_seqs, head["g_probs"], head["g_logits"],
                                            out_act)
            H = head["init"][0].shape[-1]
            top, dl = h_seqs[-1].reshape(T * rows, H), g["dlogits"].reshape(T * rows, d)
            wsets = [(h_seqs[i - 1] if i else torch.cat([head["start"][None], probs[:-1]]),
                      torch.cat([head["init"][i][None], h_seqs[i][:-1]]), g["rh"][i], g["da"][i])
                     for i in range(n)]
            wide_top, wide_sets = top.float(), [widened(*ws) for ws in wsets]

            def kernel_w(top=top, dl=dl, ws=wsets):
                dwo = torch.empty(top.shape[1], dl.shape[1], device=dev)
                dbo = torch.empty(dl.shape[1], device=dev)
                grad_reduce(top, dl, dwo, dbo)
                return (dwo, dbo, *(t for s_ in ws for t in gru_weight_grads(*s_)))

            def plain_w(top=top, dl=dl, ws=wsets):
                return (*grad_reduce_reference(top, dl, True),
                        *(t for s_ in ws for t in plain_weight_grads(*s_)))

            def library_w(top=wide_top, dl=dl, ws=wide_sets):
                return (top.t() @ dl, dl.sum(0), *(t for s_ in ws for t in cublas_weight_grads(*s_)))

            out = run(f"W bf16 {name} head", kernel_w, plain_w, [(rel, W_REL_L2)] * (2 + 3 * n),
                      **tf32_work(2 * T * rows * H * d + sum(weight_grad_flops(x_, hp)
                                                             for x_, hp, _, _ in wsets), 2),
                      inputs=[top, dl, wsets], library_fn=library_w)
            if timed:
                results["grad_reduce_bf16"][f"decode {name}"] = out
            # D + E + W against the plain backward
            leaves = [t.clone().requires_grad_() for t in gd._flatten_head(head)]
            lhead = dict(head, **gd._unflatten_heads([(n, out_act, T)], leaves)[0])
            got_p, got_l = gd._decode_heads_train([lhead])[0]
            got = torch.autograd.grad((got_p, got_l), leaves, (head["g_probs"], head["g_logits"]))
            want = plain_decode_vjp(head, head["g_probs"], head["g_logits"])
            check(f"D+E+W bf16 grads {name} B={rows}", lambda: got, lambda: want,
                  [BF16_GRAD_OP] * len(want))
    check_controls(found)
    print(f"[bf16 fused kernels] A, C, W, D and E in bf16 agree with their plain versions at "
          f"B = {B} and {RAGGED}; the autograd ops' gradients with the plain backward")
    return results


def check_controls(found):
    """Prints the one-step kernels' relative L2 (held to BF16_STEP_REL_L2
    by their checks) beside three wrong plain versions against the right
    ones at B = 256: r * h
    rounded to bf16 in A (one step of notes L1), the gate grads rounded to
    bf16 before W sums them (notes L1's dW and dU, the smaller of the two),
    layer 2 fed the rounded h1 in D (one step of the notes head: probs and
    h2, the larger). Each must land over the relative L2 its kernel is held
    to (BF16_STEP_REL_L2, W_REL_L2), or the limit does not tell a wrong
    kernel from a sound one."""
    limits = {"A: r*h rounded": BF16_STEP_REL_L2, "W: gate grads rounded": W_REL_L2,
              "D: layer 2 fed the rounded h1": BF16_STEP_REL_L2}
    print("[bf16 fused kernels] relative L2 from the plain version: " + ", ".join(
        f"{k} {v:.3e}" + (f" (must exceed {limits[k]:.1e})" if k in limits else "")
        for k, v in found.items()))
    for what, err in ((k, v) for k, v in found.items() if k in limits):
        if not err > limits[what]:
            raise RuntimeError(f"the control {what} lands {err:.3e} from the plain version, "
                               f"inside {limits[what]:.1e}")


def phase_bf16_wide_kernels():
    """Phase 33: bf16 on the wide route at wide512_bf16's shapes
    (Config(lstm_size=512, compute_dtype="bfloat16"): T 64, H 512), the
    params and batch cast to bf16 as the model casts them. Per encoder layer
    (xp = x @ W + b in bf16, as the model computes it): kernel X
    (csrc/gru_encoder_scan.cu), which serves row 9 in bf16 through
    gru_layer_xp, G's bf16 build (csrc/gru_layer_xp_bwd.cu) and W for dU
    from G's float32 gate grads; per decode head of 8 outputs or more (notes,
    2 layers, D 61; instrument, 1 layer, D 16, 4 steps): the wide D's and
    E's bf16 builds (csrc/gru_decode_train.cu, csrc/gru_decode_bwd.cu) and W
    over E's bf16-rounded streams. Each against its plain bf16 version at
    B = 256 (timed, with bounds: bf16 x bf16 products at the bf16 rate, the
    rest at the float32 rate; W beside cuBLAS on the widened operands) and
    B = 5; G's float32 gate grads, and E's dlogits and gate grads (each
    equal to its own bf16 rounding), against the plain versions' at
    STREAM_REL_L2; the autograd ops' gradients against the plain backward;
    and the controls (``check_wide_controls``): G's gate grads rounded and
    E's left unrounded (each over STREAM_REL_L2), dU summed from the rounded
    dxp (row 12's rounding, where row 10 sums the float32 gate grads), the
    heads' weight grads summed from the unrounded streams (the narrow
    route's, where row 14's pass 2 sums the rounded ones), and one D step
    with layer 2 fed the rounded h1."""
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.rnn import init_decoder_states
    from midi_vae_tpu_torch.models.vae import MidiVAE, _cast_tree
    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops import gru_layer as gl
    from midi_vae_tpu_torch.ops.grad_reduce import (
        grad_reduce,
        grad_reduce_reference,
        gru_u_grad,
        gru_weight_grads,
    )

    cfg = Config(lstm_size=512, compute_dtype="bfloat16")
    H = cfg.lstm_size
    dev, bf = torch.device("cuda"), torch.bfloat16
    model = MidiVAE(cfg).to(dev)
    params = _cast_tree(model.params, bf)
    enc, dec = params["encoder"], params["decoder"]
    gen = torch.Generator(device=dev).manual_seed(33)
    tm = lambda a: a.transpose(0, 1).contiguous()  # noqa: E731
    keys = ("gru_encoder_scan_wide_bf16", "gru_layer_xp_bwd_bf16", "grad_reduce_wide_bf16",
            "gru_decode_train_wide_bf16", "gru_decode_bwd_wide_bf16",
            "gru_decode_train_wide_chain_bf16", "gru_decode_train_wide_block_bf16",
            *(f"{k}_wide_bf16" for k in E_PHASES), *(f"{k}_bf16" for k in G_PHASES))
    results = {k: {} for k in keys}
    found = {}

    def cot(shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def plain_u(hprev, rh, da):
        n = hprev.shape[0] * hprev.shape[1]
        da = da.reshape(n, 3 * H)
        return torch.cat([grad_reduce_reference(hprev.reshape(n, H), da[:, : 2 * H])[0],
                          grad_reduce_reference(rh.reshape(n, H), da[:, 2 * H :])[0]], 1)

    def cublas_u(hprev, rh, da):
        n = hprev.shape[0] * hprev.shape[1]
        da = da.reshape(n, 3 * H)
        return torch.cat([hprev.reshape(n, H).t() @ da[:, : 2 * H],
                          rh.reshape(n, H).t() @ da[:, 2 * H :]], 1)

    def kernel_d(head, block=False):
        """The wide D on ``head``: its route's (the chain), or with ``block``
        the per-block route's."""
        fwd = (lambda hs: d_block(hs, "D_wide_bf16")) if block else gd.gru_decode_fwd_train_wide
        probs, logits, h_seqs = fwd([head])[0]
        return probs, logits, *h_seqs

    def plain_d(head):
        probs, logits, h_seqs = gd.gru_decode_train_reference(
            head["cells"], head["out"], head["init"], head["start"], head["T"],
            head["out_activation"])
        return probs, logits, *h_seqs

    def plain_e(head, wide=True):
        return gd.gru_decode_bwd_reference(head["cells"], head["out"], head["init"], head["start"],
                                           head["probs"], head["h_seqs"], head["g_probs"],
                                           head["g_logits"], head["out_activation"], wide)

    for rows in (B, RAGGED):
        timed = rows == B
        run = compare if timed else check
        batch = {k: torch.as_tensor(v, device=dev).to(bf)
                 for k, v in random_batch(cfg, rows, 33).items()}
        h0 = torch.zeros(rows, H, device=dev, dtype=bf)

        def xp_of(x, p):  # xp = x @ W + b in bf16, as the model's wide branch
            T = x.shape[0]
            return (x.reshape(T * rows, -1) @ p["w"] + p["b"]).reshape(T, rows, 3 * H)

        with torch.no_grad():
            p1 = enc["notes_rnn"][0]
            seq1 = gl.gru_layer_xp_reference(xp_of(tm(batch["X"]), p1), h0, p1["u"])
        layer_cases = [("notes_l1", tm(batch["X"]), enc["notes_rnn"][0], True),
                       ("notes_l2", seq1, enc["notes_rnn"][1], False),
                       ("instrument", tm(batch["I"]), enc["inst_rnn"][0], False),
                       ("velocity", tm(batch["V"]), enc["vel_rnn"][0], False)]
        for name, x, p, rs in layer_cases:
            with torch.no_grad():
                xp = xp_of(x, p)
            u = p["u"].detach()
            T = x.shape[0]
            fargs = (xp, h0, u)
            # h @ U[:, :2H] of two bf16 operands; (r * h) @ U[:, 2H:] takes the float32 r * h
            out = run(f"X bf16 (row 9) {name} xp{tuple(xp.shape)}",
                      lambda a=fargs: gl.gru_layer_xp(*a),
                      lambda a=fargs: gl.gru_layer_xp_reference(*a), [BF16],
                      **x_work(T, rows, H), inputs=fargs)
            if timed:
                results["gru_encoder_scan_wide_bf16"][name] = out
            with torch.no_grad():
                seq = gl.gru_layer_xp_reference(*fargs)
            g = cot(seq.shape if rs else seq.shape[1:])
            gargs = (xp, seq, h0, g if rs else None, None if rs else g, u)
            # dxp, dh0 (bf16 grads), da_cat (float32 grads), r*h (a float32
            # value); the pre-pass's hprev @ U[:, :2H] is one bf16 product,
            # (r * h) @ U[:, 2H:] two (r * h split), the chain's da @ U^T
            # three (da split): g_work
            out = run(f"G bf16 {name} rs={rs}", lambda a=gargs: gl.gru_layer_xp_bwd(*a),
                      lambda a=gargs: gl.gru_layer_xp_bwd_reference(*a),
                      [BF16_OUT, BF16_OUT, rel, H_ATOL], **g_work(xp, u),
                      inputs=[t for t in gargs if t is not None])
            if timed:
                results["gru_layer_xp_bwd_bf16"][name] = out
            # G bf16's phases; its per-block route beside them on notes L1
            for phase, res in g_phase_checks(run, f"{name} rs={rs}", gargs,
                                             block=timed and name == "notes_l1").items():
                if timed:
                    results[phase][name] = res
            dxp, dh0_plain, da, rh = gl.gru_layer_xp_bwd_reference(*gargs)
            # dU's operand: G's gate grads unrounded, in float32
            err = rel_l2(gl.gru_layer_xp_bwd(*gargs)[2], da)
            if not err <= STREAM_REL_L2:
                raise RuntimeError(f"G bf16 {name}: the gate grads lie {err:.3e} from the plain "
                                   f"version's, over {STREAM_REL_L2:.1e}")
            if timed and name == "notes_l1":
                found["G notes_l1 gate grads (the kernel)"] = err
                found["G: gate grads rounded"] = rel_l2(da.to(bf), da)
            hprev = torch.cat([h0[None], seq[:-1]])
            uargs = (hprev, rh, da)
            out = run(f"W bf16 {name} dU", lambda a=uargs: gru_u_grad(*a),
                      lambda a=uargs: plain_u(*a), [(rel, W_REL_L2)],
                      **tf32_work(2 * T * rows * u.numel(), 2), inputs=uargs,
                      library_fn=lambda a=uargs: cublas_u(a[0].float(), *a[1:]))
            if timed:
                results["grad_reduce_wide_bf16"][f"encoder {name}"] = out
                if name == "notes_l1":
                    found["G+W: dU from the rounded dxp"] = rel_l2(plain_u(hprev, rh, dxp.float()),
                                                                   plain_u(*uargs))
            # X + G + W against the plain backward (G's plain version, W's)
            leaves = [t.clone().requires_grad_() for t in fargs]
            got = torch.autograd.grad(gl.gru_layer_train(*leaves, rs), leaves, g)
            check(f"X+G+W bf16 grads {name} B={rows}", lambda: got,
                  lambda: (dxp, dh0_plain, plain_u(*uargs).to(bf)), [BF16_GRAD_OP] * 3)

        with torch.no_grad():
            z = model.encode({k: v.float() for k, v in batch.items()}).to(bf)
        new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
        for name, d, T, out_act in (("notes", cfg.output_dim, cfg.output_length, cfg.activation),
                                    ("instrument", cfg.meta_instrument_dim,
                                     cfg.meta_instrument_length, cfg.meta_instrument_activation)):
            h = dec[name]
            with torch.no_grad():
                states = init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                             cfg.lstm_state_activation)
            head = {"cells": [{k: c[k].detach() for k in "wub"} for c in h["cells"]],
                    "out": {k: h["out"][k].detach() for k in "wb"},
                    "init": [s_[0].detach() for s_ in states],
                    "start": torch.zeros(rows, d, device=dev, dtype=bf), "T": T,
                    "out_activation": out_act}
            n = len(head["cells"])
            tag = f"{name} ({n}L D={d} T={T} {out_act})"
            dinputs = [head["cells"], head["out"], head["init"], head["start"]]
            out = run(f"D wide bf16 {tag}", lambda h_=head: kernel_d(h_),
                      lambda h_=head: plain_d(h_), [BF16_OUT] * (2 + n), **d_work([head]),
                      inputs=dinputs)
            # the per-block route (the first design) on the same head, and
            # the tensor-core instance of the chain
            blk = run(f"D wide bf16 per-block route {tag}", lambda h_=head: kernel_d(h_, True),
                      lambda h_=head: plain_d(h_), [BF16_OUT] * (2 + n), **d_work([head]),
                      inputs=dinputs)
            dwide_tc_checks([head], BF16_OUT, BF16_OUT)
            if timed:
                results["gru_decode_train_wide_bf16"][name] = out
                results["gru_decode_train_wide_chain_bf16"][name] = out
                results["gru_decode_train_wide_block_bf16"][name] = blk
            if timed and n == 2:
                # one step from the head's initial states: the control's ground
                step1 = dict(head, T=1)
                found["D wide one step (the kernel)"] = max(_check(
                    f"D wide bf16 {name} one step", lambda h_=step1: kernel_d(h_),
                    lambda h_=step1: plain_d(h_), [BF16_STEP] * (2 + n))[1])
                want1, wrong = plain_d(step1), decode_rounding_h1(step1)
                found["D wide: layer 2 fed the rounded h1"] = max(rel_l2(wrong[0], want1[0]),
                                                                  rel_l2(wrong[1], want1[-1]))
            probs, _logits, *h_seqs = plain_d(head)
            head.update(probs=probs, h_seqs=h_seqs, g_probs=cot(probs.shape),
                        g_logits=cot(probs.shape))
            bwd_flat = lambda o: (o["dlogits"], *o["da"], *o["rh"], *o["d_init"], o["d_start"])  # noqa: E731
            # dlogits and the gate grads leave as bf16 values: a flip of a
            # float32 sum's order moves an entry by one bf16 step (BF16_OUT)
            out = run(f"E wide bf16 {tag}", lambda h_=head: bwd_flat(gd.gru_decode_bwd_wide([h_])[0]),
                      lambda h_=head: bwd_flat(plain_e(h_)),
                      [BF16_OUT] * (1 + n) + [H_ATOL] * n + [BF16_OUT] * (n + 1),
                      **e_work([head]),
                      inputs=[head[k] for k in ("cells", "out", "init", "start", "probs",
                                                "h_seqs", "g_probs", "g_logits")])
            if timed:
                results["gru_decode_bwd_wide_bf16"][name] = out
            for phase, res in e_phase_checks(run, tag, [head], "E_wide_bf16").items():
                if timed:
                    results[phase.removesuffix("_bf16") + "_wide_bf16"][name] = res
            # the streams pass 2 sums (row 14's rounding): each holds bf16
            # values and lies within STREAM_REL_L2 of the plain version's
            ke, pe, ue = gd.gru_decode_bwd_wide([head])[0], plain_e(head), plain_e(head, False)
            for what, i in (("dlogits", None), *((f"da{k + 1}", k) for k in range(n))):
                kt, pt, ut = ((o["dlogits"] if i is None else o["da"][i]) for o in (ke, pe, ue))
                if not torch.equal(kt, kt.to(bf).float()):
                    raise RuntimeError(f"E wide bf16 {name}: its {what} holds values that are not bf16")
                err = rel_l2(kt, pt)
                if not err <= STREAM_REL_L2:
                    raise RuntimeError(f"E wide bf16 {name}: its {what} lies {err:.3e} from the "
                                       f"plain version's, over {STREAM_REL_L2:.1e}")
                if timed:
                    found[f"E wide {name} {what} (the kernel)"] = err
                    found[f"E wide {name} {what}: unrounded"] = rel_l2(ut, pt)
            wsets = {}
            for wide in (True, False):
                g = plain_e(head, wide)
                wsets[wide] = (h_seqs[-1].reshape(T * rows, H), g["dlogits"].reshape(T * rows, d),
                               [(h_seqs[i - 1] if i else torch.cat([head["start"][None], probs[:-1]]),
                                 torch.cat([head["init"][i][None], h_seqs[i][:-1]]), g["rh"][i],
                                 g["da"][i]) for i in range(n)])

            def kernel_w(ws=wsets[True]):
                top, dl, cells = ws
                dwo = torch.empty(H, dl.shape[1], device=dev)
                dbo = torch.empty(dl.shape[1], device=dev)
                grad_reduce(top, dl, dwo, dbo)
                return (dwo, dbo, *(t for c in cells for t in gru_weight_grads(*c)))

            def plain_w(ws=wsets[True]):
                top, dl, cells = ws
                return (*grad_reduce_reference(top, dl, True),
                        *(t for c in cells for t in plain_weight_grads(*c)))

            def library_w(ws=wsets[True]):
                top, dl, cells = ws
                top = top.float()
                return (top.t() @ dl, dl.sum(0),
                        *(t for c in cells for t in cublas_weight_grads(*(x.float() for x in c))))

            out = run(f"W bf16 {name} head (rounded streams)", kernel_w, plain_w,
                      [(rel, W_REL_L2)] * (2 + 3 * n),
                      **tf32_work(2 * T * rows * H * d + sum(weight_grad_flops(c[0], c[1])
                                                             for c in wsets[True][2]), 2),
                      inputs=list(wsets[True]), library_fn=library_w)
            if timed:
                results["grad_reduce_wide_bf16"][f"decode {name}"] = out
                # dW and dU of each cell and dWo: from the unrounded streams
                want_w = plain_w()
                wrong_w = plain_w(wsets[False])
                found[f"E wide+W {name}: unrounded streams"] = min(
                    rel_l2(wrong_w[i], want_w[i]) for i in
                    [0] + [j for c in range(n) for j in (2 + 3 * c, 4 + 3 * c)])
            # D + E + W against the plain backward
            leaves = [t.clone().requires_grad_() for t in gd._flatten_head(head)]
            lhead = dict(head, **gd._unflatten_heads([(n, out_act, T)], leaves)[0])
            got_p, got_l = gd._decode_heads_train([lhead], ("D_wide_bf16", "E_wide_bf16"))[0]
            got = torch.autograd.grad((got_p, got_l), leaves, (head["g_probs"], head["g_logits"]))
            want = plain_decode_vjp(head, head["g_probs"], head["g_logits"], wide=True)
            check(f"D+E+W wide bf16 grads {name} B={rows}", lambda: got, lambda: want,
                  [BF16_GRAD_OP] * len(want))
    # X and G bf16 (and G's phases) at B = 128, the bf16 GRU(512)'s batch
    # there (notes L2: rows 9 and 10)
    rows = 128
    batch = {k: torch.as_tensor(v, device=dev).to(bf) for k, v in random_batch(cfg, rows, 34).items()}
    h0 = torch.zeros(rows, H, device=dev, dtype=bf)
    with torch.no_grad():
        x1, (p1, p2) = tm(batch["X"]), enc["notes_rnn"]
        T1 = x1.shape[0]
        seq = gl.gru_layer_xp_reference(
            (x1.reshape(T1 * rows, -1) @ p1["w"] + p1["b"]).reshape(T1, rows, 3 * H), h0, p1["u"])
        xp = (seq.reshape(T1 * rows, H) @ p2["w"] + p2["b"]).reshape(T1, rows, 3 * H)
        u = p2["u"].detach()
        seq2 = gl.gru_layer_xp_reference(xp, h0, u)
    check(f"X bf16 (row 9) notes_l2 B={rows}", lambda: gl.gru_layer_xp(xp, h0, u),
          lambda: gl.gru_layer_xp_reference(xp, h0, u), [BF16])
    gargs = (xp, seq2, h0, None, cot(seq2.shape[1:]), u)
    check(f"G bf16 notes_l2 B={rows}", lambda: gl.gru_layer_xp_bwd(*gargs),
          lambda: gl.gru_layer_xp_bwd_reference(*gargs), [BF16_OUT, BF16_OUT, rel, H_ATOL])
    g_phase_checks(check, f"notes_l2 B={rows}", gargs)
    check_wide_controls(found)
    print(f"[bf16 wide kernels] X, G, the wide D and E in bf16 and W agree with their plain "
          f"versions at B = {B}, 128 (X, G) and {RAGGED}; the autograd ops' gradients with the "
          "plain backward")
    return results


def check_wide_controls(found):
    """Prints the kernels' relative L2 at B = 256 (the one-step D, G's gate
    grads on notes L1 and E wide's streams, held to BF16_STEP_REL_L2 and
    STREAM_REL_L2 by their checks) beside wrong plain versions against the
    right ones: G's gate grads rounded to bf16 and E wide's streams left
    unrounded (the narrow route's), dU summed from the rounded dxp (notes
    L1), the heads' dW, dU and dWo summed from the unrounded dlogits and
    gate grads (the smallest over each head's matrices), and one D step with
    layer 2 fed the rounded h1. Each must land over the relative L2 its
    kernel is held to (STREAM_REL_L2, W_REL_L2, BF16_STEP_REL_L2), or the
    limit does not tell the wrong rounding from the kernel's."""
    limits = {k: W_REL_L2 for k in found if k.startswith(("G+W", "E wide+W"))}
    limits.update({k: STREAM_REL_L2 for k in found
                   if k.endswith(": unrounded") or k == "G: gate grads rounded"})
    limits["D wide: layer 2 fed the rounded h1"] = BF16_STEP_REL_L2
    print("[bf16 wide kernels] relative L2 from the plain version: " + ", ".join(
        f"{k} {v:.3e}" + (f" (must exceed {limits[k]:.1e})" if k in limits else "")
        for k, v in found.items()))
    for what, err in ((k, v) for k, v in found.items() if k in limits):
        if not err > limits[what]:
            raise RuntimeError(f"the control {what} lands {err:.3e} from the plain version, "
                               f"inside {limits[what]:.1e}")


def lstm_rounding_controls(xp, h0, c0, u):
    """Two wrong plain forwards of a bf16 LSTM layer over xp (T, B, 4H), each
    a (h sequence, c sequence) pair in bf16: every op in bf16 (the products,
    the gates and the cell update rounded as they go; the Pallas kernels keep
    them in float32), and c carried in float32 and stored rounded (the
    kernels round the c they carry to bf16, as h). Over one step the second
    equals the right forward: only a second step reads the carried c."""
    import torch

    H = h0.shape[-1]
    found = {}
    for what in ("every op in bf16", "c carried in float32"):
        h, c, hs, cs = h0, c0 if what == "every op in bf16" else c0.float(), [], []
        for t in range(xp.shape[0]):
            if what == "every op in bf16":
                gates = xp[t].to(h0.dtype) + h @ u
            else:
                gates = xp[t].float() + h.float() @ u.float()
            i, f = torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H : 2 * H])
            g, o = torch.tanh(gates[:, 2 * H : 3 * H]), torch.sigmoid(gates[:, 3 * H :])
            c = f * c + i * g
            h = (o * torch.tanh(c)).to(h0.dtype)
            hs.append(h)
            cs.append(c.to(h0.dtype))
        found[what] = (torch.stack(hs), torch.stack(cs))
    return found


def phase_bf16_lstm_kernels():
    """Phase 36: the bf16 LSTM's encoder with the default fused flags, the
    params and batch cast to bf16 as the model casts them, T 64. At
    Config(cell_type="LSTM", compute_dtype="bfloat16")'s shapes (the TPU's
    rows 19 and 20 at B = 256, H = 256), per encoder layer: L's bf16 build
    (csrc/lstm_layer_fwd.cu) with the c sequence, N's (csrc/lstm_layer_bwd.cu)
    and W's bf16 build over N's float32 gate grads (dW, db, dU); at
    LSTM(512)'s (rows 17 and 18), over xp = x @ W + b in bf16: Q's bf16 build
    (csrc/lstm_layer_xp_fwd.cu), R's (csrc/lstm_layer_xp_bwd.cu, without its
    float32 gate grads, as row 18 has none) and W bf16 for dU from R's
    rounded dxp. Each against its plain bf16 version at B = 256 (timed, with
    bounds: bf16 x bf16 products at the bf16 rate, the rest at the float32
    rate; cuDNN's bf16 LSTM forward and backward beside L, N, Q and R; W
    beside cuBLAS on the widened operands) and B = 5; N's and R's float32
    gate grads (R's as row 16 emits them) against the plain versions' at
    STREAM_REL_L2; L and Q also two steps from a random state at
    BF16_STEP_REL_L2; the autograd ops' gradients against the plain
    backward (Q + R + W in "wide" and "inplace"), and their dU against the
    plain sum of their row's gate grads over their kernels' own streams at
    STREAM_REL_L2; and the controls (``check_lstm_controls``): the layer on
    two steps with every op in bf16 and with c carried in float32, dU from
    the other row's gate grads; and each of N's and R's phases against its
    plain version (``bptt_phase_checks``), and on notes L2 their chain over
    its last two steps against the chain with da rounded to bf16 before the
    dh product, a control that must land over BF16_STEP_REL_L2
    (``chain_two_steps``)."""
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.vae import MidiVAE, _cast_tree
    from midi_vae_tpu_torch.ops import lstm_layer as ll
    from midi_vae_tpu_torch.ops.grad_reduce import (
        grad_reduce_reference,
        lstm_u_grad,
        lstm_weight_grads,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(36)
    tm = lambda a: a.transpose(0, 1).contiguous()  # noqa: E731
    keys = ("lstm_layer_fwd_bf16", "lstm_layer_bwd_bf16", "lstm_layer_xp_fwd_bf16",
            "lstm_layer_xp_bwd_bf16", "grad_reduce_lstm_bf16", "grad_reduce_lstm_512_bf16",
            *(f"{k}_bf16" for k in (*BPTT_PHASES, *L_PHASES)))
    results = {k: {} for k in keys}
    found = {}

    def cot(shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def plain_w(x, hprev, da):
        n, G = x.shape[0] * x.shape[1], da.shape[-1]
        d2 = da.reshape(n, G).float()
        return (*grad_reduce_reference(x.reshape(n, -1), d2, True),
                grad_reduce_reference(hprev.reshape(n, -1), d2)[0])

    def cublas_w(x, hprev, da):
        n, G = x.shape[0] * x.shape[1], da.shape[-1]
        d2 = da.reshape(n, G).float()
        return x.reshape(n, -1).float().t() @ d2, d2.sum(0), hprev.reshape(n, -1).float().t() @ d2

    def plain_u(hprev, da):
        n = hprev.shape[0] * hprev.shape[1]
        return grad_reduce_reference(hprev.reshape(n, -1), da.reshape(n, -1).float())[0]

    def held_u(tag, got_u, hprev, right, wrong):
        """The autograd op's dU (bf16) against the plain sum of the gate grads
        its row sums (``right``) over its kernels' own streams, rounded to
        bf16: only W's order of summation differs, so a rounding flips here
        and there (STREAM_REL_L2). Returns that and the relative L2 of the
        other row's sum (``wrong``), the control, from the same plain sum."""
        want = plain_u(hprev, right).to(bf)
        err = rel_l2(got_u, want)
        if not err <= STREAM_REL_L2:
            raise RuntimeError(f"{tag}: the op's dU lies {err:.3e} from the plain sum of its "
                               f"row's gate grads, over {STREAM_REL_L2:.1e}")
        return err, rel_l2(plain_u(hprev, wrong).to(bf), want)

    def two_steps(tag, kernel_fn, xp, u, rows):
        """The layer's forward on two steps from a random bf16 state: the
        kernel's h and c of both steps against the plain version's at
        BF16_STEP, and the controls' (which must land over it); for L, whose
        xp is float32, also the plain chain over xp rounded to bf16 (Q's
        input, not L's)."""
        h0 = (0.5 * torch.tanh(torch.randn(rows, u.shape[0], generator=gen, device=dev))).to(bf)
        c0 = (0.5 * torch.randn(rows, u.shape[0], generator=gen, device=dev)).to(bf)
        want = ll.lstm_layer_xp_reference(xp[:2], h0, c0, u)
        found[f"{tag} two steps (the kernel)"] = max(_check(
            f"{tag} two steps", lambda: kernel_fn(h0, c0), lambda: want, [BF16_STEP] * 2)[1])
        controls = lstm_rounding_controls(xp[:2], h0, c0, u)
        if xp.dtype == torch.float32:
            controls["xp rounded to bf16"] = ll.lstm_layer_xp_reference(xp[:2].to(bf), h0, c0, u)
        for what, (hs, cs) in controls.items():
            found[f"{tag}: {what}, two steps"] = max(rel_l2(hs, want[0]), rel_l2(cs, want[1]))

    for rows in (B, RAGGED):
        timed = rows == B
        run = compare if timed else check
        # --- LSTM(256): L, N and W in bf16 (rows 19 and 20)
        cfg = Config(cell_type="LSTM", compute_dtype="bfloat16")
        H = cfg.lstm_size
        params = _cast_tree(MidiVAE(cfg).to(dev).params, bf)
        enc = params["encoder"]
        batch = {k: torch.as_tensor(v, device=dev).to(bf)
                 for k, v in random_batch(cfg, rows, 36).items()}
        h0 = torch.zeros(rows, H, device=dev, dtype=bf)
        with torch.no_grad():
            p1 = [enc["notes_rnn"][0][k].detach() for k in "wbu"]
            x_l2 = ll.lstm_layer_reference(tm(batch["X"]), h0, h0, *p1, "tanh", True)
        layer_cases = [("notes_l1", tm(batch["X"]), enc["notes_rnn"][0], True, False),
                       ("notes_l2", x_l2, enc["notes_rnn"][1], False, True),
                       ("instrument", tm(batch["I"]), enc["inst_rnn"][0], False, False),
                       ("velocity", tm(batch["V"]), enc["vel_rnn"][0], False, False)]
        for name, x, p, rs, need_dx in layer_cases:
            w, b, u = (p[k].detach() for k in "wbu")
            T, D = x.shape[0], x.shape[-1]
            p_ = {"w": w, "b": b, "u": u}
            args = (x, h0, h0, w, b, u, "tanh", True, True)
            library = cudnn_lstm_layer(x, p_, h0, h0) if timed else (None, None, None)
            # x @ W and h @ U are bf16 products (the velocity layer's cast_x
            # widens x and W: the same products)
            out = run(f"L bf16 {name} x{tuple(x.shape)} with c", lambda a=args: ll.lstm_layer(*a),
                      lambda a=args: ll.lstm_layer_reference(*a), [BF16_OUT, BF16_OUT],
                      flops=layer_flops(T, rows, w, u), inputs=args[:6], peak=PEAK_BF16_FLOPS,
                      library_fn=library[0])
            for phase, res in l_phase_checks(run, f"{name} with c", args).items():
                if timed:
                    results[phase][name] = res
            blk = run(f"L block bf16 {name} x{tuple(x.shape)} with c",
                      lambda a=args: ll.lstm_layer_block(*a),
                      lambda a=args: ll.lstm_layer_reference(*a), [BF16_OUT, BF16_OUT],
                      flops=layer_flops(T, rows, w, u), inputs=args[:6], peak=PEAK_BF16_FLOPS)
            if timed:
                results["lstm_layer_block_bf16"][name] = blk
                results["lstm_layer_fwd_bf16"][name] = out
                if name == "notes_l1":
                    with torch.no_grad():
                        xp1 = (x.reshape(T * rows, D).float() @ w.float() + b.float()).reshape(
                            T, rows, 4 * H)
                    two_steps("L", lambda h_, c_, x=x: ll.lstm_layer(x[:2], h_, c_, w, b, u,
                                                                    "tanh", True, True), xp1, u,
                              rows)
            with torch.no_grad():
                hseq, cseq = ll.lstm_layer_reference(*args)
            g = cot(hseq.shape if rs else hseq.shape[1:])
            bargs = (x, hseq, cseq, h0, h0, g if rs else None, None if rs else g, w, b, u, need_dx)
            flat = lambda o: tuple(t for t in o if t is not None)  # noqa: E731
            # the recompute's x @ W and h @ U are bf16 products; da @ U^T and
            # da @ W^T take the float32 gate grads
            out = run(f"N bf16 {name} rs={rs} dx={need_dx}",
                      lambda a=bargs: flat(ll.lstm_layer_bwd(*a)),
                      lambda a=bargs: flat(ll.lstm_layer_bwd_reference(*a)),
                      [BF16_OUT] * (3 if need_dx else 2) + [rel],
                      flops=layer_flops(T, rows, w, u),
                      flops_f32=lstm_bwd_flops(T, rows, w, u, need_dx) - layer_flops(T, rows, w, u),
                      inputs=bargs[:10], peak=PEAK_BF16_FLOPS, library_fn=library[1])
            if timed:
                results["lstm_layer_bwd_bf16"][name] = out
            for phase, res in bptt_phase_checks(run, "N", f"{name} rs={rs}", bargs).items():
                if timed:
                    results[phase][name] = res
            if timed and name == "notes_l2":
                found.update(chain_two_steps("N", bargs))
            dx, dh0_p, dc0_p, da = ll.lstm_layer_bwd_reference(*bargs)
            err = rel_l2(ll.lstm_layer_bwd(*bargs)[3], da)
            if not err <= STREAM_REL_L2:
                raise RuntimeError(f"N bf16 {name}: the gate grads lie {err:.3e} from the plain "
                                   f"version's, over {STREAM_REL_L2:.1e}")
            hprev = torch.cat([h0[None], hseq[:-1]])
            wargs = (x, hprev, da)
            out = run(f"W bf16 LSTM {name} dW, db, dU", lambda a=wargs: lstm_weight_grads(*a),
                      lambda a=wargs: plain_w(*a), [(rel, W_REL_L2)] * 3,
                      **tf32_work(2 * T * rows * (w.numel() + u.numel()), 2), inputs=wargs,
                      library_fn=lambda a=wargs: cublas_w(*a))
            if timed:
                results["grad_reduce_lstm_bf16"][f"encoder {name}"] = out
                if name == "notes_l1":
                    found["N gate grads (the kernel)"] = err
            # L + N + W against the plain backward (N's plain version, W's)
            leaves = [t.clone().requires_grad_(i > 0 or need_dx)
                      for i, t in enumerate((x, h0, h0, w, b, u))]
            wanted = [t for t in leaves if t.requires_grad]
            got = torch.autograd.grad(ll.lstm_layer_train_x(*leaves, rs), wanted, g)
            pw = plain_w(*wargs)
            want = ((dx,) if need_dx else ()) + (dh0_p, dc0_p, pw[0].to(bf), pw[1].to(bf),
                                                 pw[2].to(bf))
            check(f"L+N+W bf16 grads {name} B={rows}", lambda: got, lambda: want,
                  [BF16_GRAD_OP] * len(want))
            # its dU from the unrounded da (row 20) over L's and N's own streams
            with torch.no_grad():
                khs, kcs = ll.lstm_layer(*args)
                kda = ll.lstm_layer_bwd(x, khs, kcs, *bargs[3:])[3]
            held = held_u(f"L+N+W {name}", got[-1], torch.cat([h0[None], khs[:-1]]), kda,
                          kda.to(bf))
            if timed and name == "notes_l1":
                found["N+W dU (the op)"], found["N+W: dU from the rounded da"] = held
        # --- LSTM(512): Q, R and W in bf16 over xp (rows 17 and 18)
        cfg = Config(cell_type="LSTM", lstm_size=512, compute_dtype="bfloat16")
        H = cfg.lstm_size
        params = _cast_tree(MidiVAE(cfg).to(dev).params, bf)
        enc = params["encoder"]
        batch = {k: torch.as_tensor(v, device=dev).to(bf)
                 for k, v in random_batch(cfg, rows, 37).items()}
        h0 = torch.zeros(rows, H, device=dev, dtype=bf)

        def xp_of(x, p):  # xp = x @ W + b in bf16, as the model's rows 17 and 18
            return (x.reshape(x.shape[0] * rows, -1) @ p["w"] + p["b"]).reshape(x.shape[0], rows,
                                                                                4 * H)

        with torch.no_grad():
            p1 = enc["notes_rnn"][0]
            x_l2 = ll.lstm_layer_xp_reference(xp_of(tm(batch["X"]), p1), h0, h0, p1["u"])[0]
        for name, x, p, rs in (("notes_l1", tm(batch["X"]), enc["notes_rnn"][0], True),
                               ("notes_l2", x_l2, enc["notes_rnn"][1], False),
                               ("instrument", tm(batch["I"]), enc["inst_rnn"][0], False),
                               ("velocity", tm(batch["V"]), enc["vel_rnn"][0], False)):
            with torch.no_grad():
                xp = xp_of(x, p)
            u = p["u"].detach()
            T = x.shape[0]
            library = (cudnn_lstm_layer(xp, {"u": u}, h0, h0, xp=True) if timed
                       else (None, None, None))
            out = run(f"Q bf16 {name} xp{tuple(xp.shape)}", lambda: ll.lstm_layer_xp(xp, h0, h0, u),
                      lambda: ll.lstm_layer_xp_reference(xp, h0, h0, u), [BF16_OUT, BF16_OUT],
                      flops=2 * T * rows * u.numel(), inputs=[xp, h0, u], peak=PEAK_BF16_FLOPS,
                      library_fn=library[0])
            if timed:
                results["lstm_layer_xp_fwd_bf16"][name] = out
                if name == "notes_l1":
                    two_steps("Q", lambda h_, c_: ll.lstm_layer_xp(xp[:2], h_, c_, u), xp, u, rows)
            with torch.no_grad():
                hseq, cseq = ll.lstm_layer_xp_reference(xp, h0, h0, u)
            g = cot(hseq.shape if rs else hseq.shape[1:])
            bargs = (xp, hseq, cseq, h0, h0, g if rs else None, None if rs else g, u)
            # row 18's: dxp, dh0, dc0 rounded, no float32 gate grads
            out = run(f"R bf16 {name} rs={rs}",
                      lambda a=bargs: ll.lstm_layer_xp_bwd(*a, need_da=False)[:3],
                      lambda a=bargs: ll.lstm_layer_xp_bwd_reference(*a)[:3], [BF16_OUT] * 3,
                      flops=2 * T * rows * u.numel(), flops_f32=2 * T * rows * u.numel(),
                      inputs=bargs, peak=PEAK_BF16_FLOPS, library_fn=library[1])
            if timed:
                results["lstm_layer_xp_bwd_bf16"][name] = out
            for phase, res in bptt_phase_checks(run, "R", f"{name} rs={rs}", bargs).items():
                if timed:
                    results[phase][name] = res
            if timed and name == "notes_l2":
                found.update(chain_two_steps("R", bargs))
            dxp, dh0_p, dc0_p, da = ll.lstm_layer_xp_bwd_reference(*bargs)
            # row 16's: the same gate grads unrounded in float32 beside dxp
            kdxp, _, _, kda = ll.lstm_layer_xp_bwd(*bargs)
            err = rel_l2(kda, da)
            if not (err <= STREAM_REL_L2 and torch.equal(kdxp, kda.to(bf))):
                raise RuntimeError(f"R bf16 {name}: the gate grads lie {err:.3e} from the plain "
                                   f"version's (limit {STREAM_REL_L2:.1e}), or dxp is not their "
                                   "bf16 rounding")
            hprev = torch.cat([h0[None], hseq[:-1]])
            out = run(f"W bf16 LSTM(512) {name} dU from the rounded dxp",
                      lambda: lstm_u_grad(hprev, dxp.float()), lambda: plain_u(hprev, dxp),
                      [(rel, W_REL_L2)], **tf32_work(2 * T * rows * u.numel(), 2),
                      inputs=[hprev, dxp],
                      library_fn=lambda: hprev.reshape(T * rows, -1).float().t()
                      @ dxp.reshape(T * rows, -1).float())
            if timed:
                results["grad_reduce_lstm_512_bf16"][f"encoder {name}"] = out
                if name == "notes_l1":
                    found["R gate grads (the kernel)"] = err
            # Q + R + W against the plain backward: "wide" (row 18) sums dU
            # from the rounded dxp, "inplace" (row 16) from the float32 gate
            # grads; then its dU over Q's and R's own streams, the other
            # row's operand as the control
            with torch.no_grad():
                khs, kcs = ll.lstm_layer_xp(xp, h0, h0, u)
                kdxp, _, _, kda = ll.lstm_layer_xp_bwd(xp, khs, kcs, *bargs[3:])
            khprev = torch.cat([h0[None], khs[:-1]])
            for mode, want_u, right, wrong, what in (
                    ("wide", plain_u(hprev, dxp), kdxp, kda, "the unrounded da"),
                    ("inplace", plain_u(hprev, da), kda, kdxp, "the rounded dxp")):
                leaves = [t.clone().requires_grad_() for t in (xp, h0, h0, u)]
                got = torch.autograd.grad(ll.lstm_layer_train(*leaves, rs, mode), leaves, g)
                check(f"Q+R+W bf16 grads {name} {mode} B={rows}", lambda: got,
                      lambda w=want_u: (dxp, dh0_p, dc0_p, w.to(bf)), [BF16_GRAD_OP] * 4)
                held = held_u(f"Q+R+W {name} {mode}", got[-1], khprev, right, wrong)
                if timed and name == "notes_l1":
                    found[f"R+W {mode} dU (the op)"] = held[0]
                    found[f"R+W {mode}: dU from {what}"] = held[1]
    # Q bf16's forward chain at B = 512: its clusters in more than one wave
    rows = 2 * B
    batch = {k: torch.as_tensor(v, device=dev).to(bf)
             for k, v in random_batch(cfg, rows, 38).items()}
    h0 = torch.zeros(rows, H, device=dev, dtype=bf)
    x, p = tm(batch["X"]), enc["notes_rnn"][0]
    with torch.no_grad():
        xp = (x.reshape(x.shape[0] * rows, -1) @ p["w"] + p["b"]).reshape(x.shape[0], rows, 4 * H)
    plan = ll.fwd_chain_plan("Q_bf16", H, rows)
    check(f"Q bf16 notes_l1 xp{tuple(xp.shape)}, {plan.clusters} clusters of {plan.rows} rows",
          lambda: ll.lstm_layer_xp(xp, h0, h0, p["u"]),
          lambda: ll.lstm_layer_xp_reference(xp, h0, h0, p["u"]), [BF16_OUT, BF16_OUT])
    check_lstm_controls(found)
    print(f"[bf16 lstm kernels] L, N, Q, R and W in bf16 agree with their plain versions at "
          f"B = {B} and {RAGGED}, Q also at {rows}; the autograd ops' gradients with the plain "
          "backward")
    return results


def chain_two_steps(letter, bargs):
    """N's or R's bf16 backward (``bargs`` as lstm_layer_bwd's or
    lstm_layer_xp_bwd's, a last layer's: d_final seeds dh) over the layer's
    last two steps, from their forward sequences: the float32 gate grads of
    step T-2, which read dh_{T-2} = da_{T-1} @ U^T, against the plain
    version's at BF16_STEP_REL_L2, and the control: the plain chain with
    da rounded to bf16 before that product (what a bf16 tensor-core product
    would take), which must land over it. Returns {what: relative L2}."""
    import torch

    from midi_vae_tpu_torch.ops import lstm_layer as ll

    x, hseq, cseq = bargs[:3]
    u = bargs[-2] if letter == "N" else bargs[-1]
    # the last two steps, from the state before them
    x2, hs2, cs2 = x[-2:], hseq[-2:], cseq[-2:]
    h_in, c_in = hseq[-3], cseq[-3]
    g = bargs[6]
    if letter == "N":
        kda = ll.lstm_layer_bwd(x2, hs2, cs2, h_in, c_in, None, g, *bargs[7:10], False)[3]
        act = ll.lstm_bwd_gates_reference(x2, hs2, h_in, u, bargs[7], bargs[8])
    else:
        kda = ll.lstm_layer_xp_bwd(x2, hs2, cs2, h_in, c_in, None, g, u)[3]
        act = ll.lstm_bwd_gates_reference(x2, hs2, h_in, u)
    da = ll.lstm_bwd_chain_reference(act, cs2, c_in, None, g, u)[0]
    # the control: da_{T-1} rounded to bf16 before dh_{T-2} = da_{T-1} @ U^T
    uf, cf = u.float(), cs2.float()
    da1, _, dc = ll.lstm_cell_bwd_act(act[1], cf[0], cf[1], uf, g.float(),
                                      torch.zeros_like(cf[0]))
    dh = da1.to(torch.bfloat16).float() @ uf.t()
    da0 = ll.lstm_cell_bwd_act(act[0], c_in.float(), cf[0], uf, dh, dc)[0]
    return {f"{letter} chain, step T-2's gate grads (the kernel)": rel_l2(kda[0], da[0]),
            f"{letter} chain: da rounded to bf16 before the dh product, two steps":
                rel_l2(da0, da[0])}


def check_lstm_controls(found):
    """Prints the kernels' relative L2 at B = 256 (L and Q on two steps, h
    and c, held to BF16_STEP_REL_L2; N's and R's float32 gate grads, held to
    STREAM_REL_L2; the autograd ops' dU on notes L1, held to STREAM_REL_L2)
    beside wrong plain versions against the right ones, in the same
    comparisons: the layer on two steps with every op in bf16, and with c
    carried in float32 and stored rounded (the larger of h and c), each over
    BF16_STEP_REL_L2; dU summed from the other row's gate grads, each over
    STREAM_REL_L2: L + N + W's from the rounded da (row 20 sums the
    unrounded one), Q + R + W's in "wide" from the unrounded da (row 18 sums
    the stored bf16 stream) and in "inplace" from the rounded dxp (row 16
    sums the unrounded da)."""
    limits = {k: BF16_STEP_REL_L2 for k in found if k.endswith(", two steps")}
    limits.update({k: STREAM_REL_L2 for k in found if ": dU from " in k})
    print("[bf16 lstm kernels] relative L2 from the plain version: " + ", ".join(
        f"{k} {v:.3e}" + (f" (must exceed {limits[k]:.1e})" if k in limits else "")
        for k, v in found.items()))
    for what, err in ((k, v) for k, v in found.items() if k in limits):
        if not err > limits[what]:
            raise RuntimeError(f"the control {what} lands {err:.3e} from the plain version, "
                               f"inside {limits[what]:.1e}")
    for what, err in ((k, v) for k, v in found.items() if " chain, " in k):
        if not err <= BF16_STEP_REL_L2:
            raise RuntimeError(f"{what} lies {err:.3e} from the plain version, over "
                               f"{BF16_STEP_REL_L2:.1e}")


def head_weight_grads(head, g):
    """The weight-grad reductions of one head from E's outputs ``g``, as
    (a, b) pairs in the order ``_DecodeTrain`` runs them: dWo (and dbo) over
    the top h sequence, then per cell dW (and db) over x, dU[:, :2H] over
    h_{t-1}, dU[:, 2H:] over r * h."""
    import torch

    T, (rows, D), H = head["T"], head["start"].shape, head["init"][0].shape[-1]
    pairs = [(head["h_seqs"][-1].reshape(T * rows, H), g["dlogits"].reshape(T * rows, D))]
    for i in range(len(head["cells"])):
        x = (head["h_seqs"][i - 1] if i else
             torch.cat([head["start"][None], head["probs"][:-1]]))
        hprev = torch.cat([head["init"][i][None], head["h_seqs"][i][:-1]])
        da = g["da"][i].reshape(T * rows, 3 * H)
        pairs += [(x.reshape(T * rows, -1), da), (hprev.reshape(T * rows, H), da[:, : 2 * H]),
                  (g["rh"][i].reshape(T * rows, H), da[:, 2 * H :])]
    return pairs


def run_weight_grads(pairs, kernel):
    """The reductions of ``head_weight_grads`` through W (``kernel``) or its
    plain version, each with the column sums where _DecodeTrain takes them
    (dbo, db)."""
    import torch

    from midi_vae_tpu_torch.ops.grad_reduce import grad_reduce, grad_reduce_reference

    outs = []
    for k, (a, b) in enumerate(pairs):
        with_bias = k == 0 or k % 3 == 1
        if kernel:
            out = torch.empty(a.shape[1], b.shape[1], device=b.device)
            bias = torch.empty(b.shape[1], device=b.device) if with_bias else None
            grad_reduce(a, b, out, bias)
            outs += [out] + ([bias] if with_bias else [])
        else:
            c, bias = grad_reduce_reference(a, b, with_bias)
            outs += [c] + ([bias] if with_bias else [])
    return tuple(outs)


def cublas_pairs(pairs):
    """The reductions of ``head_weight_grads`` as cuBLAS's ``a.t() @ b`` on
    the widened operands, with the same column sums: W's library call."""
    return tuple(t for k, (a, b) in enumerate(pairs)
                 for t in ((a.float().t() @ b, b.sum(0)) if k == 0 or k % 3 == 1
                           else (a.float().t() @ b,)))


def phase_residual_kernels():
    """Phase 39: the last kernel instances a config reaches at H <= 512.
    (1) decode_residual_bf16 at Config(meta_held_notes=True)'s shapes,
    B = 256 and B = 5: the notes + velocity and notes + velocity + held
    multi-head calls through D's bf16-residual build
    (csrc/gru_decode_train.cu), whose probs and logits must equal the float32
    build's bit for bit and whose stored h sequences must equal the float32
    build's rounded to bf16; E's bf16-residual build (csrc/gru_decode_bwd.cu)
    over the plain forward's rounded sequences and W over them, against
    their plain versions at the training kernels' limits, with a control (E
    fed the float32 sequences must land over the limit); the autograd op's
    gradients against the plain backward. (2) Rows 7 and 8 in bf16 at H = 512
    (Config(lstm_size=512, compute_dtype=bfloat16, batch_size=128)'s
    instrument head, B = 128 and B = 5): D's wide bf16 build (row 7's
    forward is row 13's), E's wide bf16 build with row 8's rounding, W over
    its unrounded streams, against their plain versions at the bf16 limits;
    its streams within STREAM_REL_L2 of the plain version's and not all
    bf16 values, where row 14's rounded build must land over STREAM_REL_L2;
    the autograd op's gradients against the plain backward. Times (CUDA
    events), bounds."""
    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models import vae as port_vae
    from midi_vae_tpu_torch.models.rnn import init_decoder_states
    from midi_vae_tpu_torch.models.vae import MidiVAE, _cast_tree
    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import gru_decode as gd

    bf, dev = torch.bfloat16, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(39)
    keys = ("gru_decode_train_resid", "gru_decode_train_chain_resid",
            "gru_decode_train_block_resid", "gru_decode_bwd_resid", "grad_reduce_resid",
            *(f"{k}_resid" for k in E_PHASES), *(f"{k}_rows78_bf16" for k in E_PHASES),
            "gru_decode_train_rows78", "gru_decode_bwd_wide_row8_bf16", "grad_reduce_rows78_bf16")
    results = {k: {} for k in keys}
    found = {}
    fwd_flat = lambda outs: tuple(t for p, l, hs in outs for t in (p, l, *hs))  # noqa: E731
    bwd_flat = lambda outs: tuple(t for o in outs for t in (  # noqa: E731
        o["dlogits"], *o["da"], *o["rh"], *o["d_init"], o["d_start"]))

    def heads_of(cfg, dec, new_encoded, rows, names, dtype=torch.float32):
        spec = {"notes": (cfg.output_dim, cfg.output_length, cfg.activation),
                "velocity": (1, cfg.meta_velocity_length, cfg.meta_velocity_activation),
                "held": (2, cfg.meta_held_notes_length, cfg.meta_held_notes_activation),
                "instrument": (cfg.meta_instrument_dim, cfg.meta_instrument_length,
                               cfg.meta_instrument_activation)}
        out = []
        for name in names:
            d, T, out_act = spec[name]
            h = dec[name]
            with torch.no_grad():
                states = init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                             cfg.lstm_state_activation)
            out.append({"cells": [{k: c[k].detach() for k in "wub"} for c in h["cells"]],
                        "out": {k: h["out"][k].detach() for k in "wb"},
                        "init": [s_[0].detach() for s_ in states],
                        "start": torch.zeros(rows, d, device=dev, dtype=dtype), "T": T,
                        "out_activation": out_act})
        return out

    def with_residuals(heads, rdt, wide=False):
        """The plain forward's probs and (``rdt``) h sequences, and random
        incoming grads, on each head."""
        with torch.no_grad():
            for h in heads:
                h["probs"], _l, h["h_seqs"] = gd.gru_decode_train_reference(
                    h["cells"], h["out"], h["init"], h["start"], h["T"], h["out_activation"], rdt)
                h["g_probs"] = torch.randn(h["probs"].shape, generator=gen, device=dev).to(
                    h["probs"].dtype)
                h["g_logits"] = torch.randn(h["probs"].shape, generator=gen, device=dev).to(
                    h["probs"].dtype)

    def plain_e(h, wide=False):
        return gd.gru_decode_bwd_reference(h["cells"], h["out"], h["init"], h["start"], h["probs"],
                                           h["h_seqs"], h["g_probs"], h["g_logits"],
                                           h["out_activation"], wide)

    def autograd_check(tag, heads, vjp_limit, builds):
        """The autograd op's gradients against the plain backward (E and W)
        over the sequences the kernels store: a sequence entry that a
        float32 sum in another order rounds the other way in bf16 would
        otherwise move the plain backward, not the op."""
        fwd = [(p, hs) for p, _l, hs in gd.gru_decode_fwd_train(heads, builds[0])]
        leaves = [[t.clone().requires_grad_() for t in gd._flatten_head(h)] for h in heads]
        lheads = [dict(h, **gd._unflatten_heads([(len(h["cells"]), h["out_activation"], h["T"])],
                                                 lv)[0]) for h, lv in zip(heads, leaves)]
        outs = gd._decode_heads_train(lheads, builds)
        got = torch.autograd.grad([t for o in outs for t in o], [t for lv in leaves for t in lv],
                                  [g for h in heads for g in (h["g_probs"], h["g_logits"])])
        want = [t for h, f in zip(heads, fwd) for t in plain_decode_vjp(
            h, h["g_probs"], h["g_logits"], False, f)]
        check(tag, lambda: got, lambda: tuple(want), [vjp_limit] * len(want))

    # (1) decode_residual_bf16: the multi-head calls of Config(meta_held_notes=True)
    cfg = Config(meta_held_notes=True)
    model = MidiVAE(cfg).to(dev)
    for rows in (B, RAGGED):
        timed = rows == B
        run = compare if timed else check
        batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, rows, 39).items()}
        with torch.no_grad():
            z = model.encode(batch)
        new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
        for call, names in (("notes+velocity", ("notes", "velocity")),
                            ("notes+velocity+held", ("notes", "velocity", "held"))):
            heads = heads_of(cfg, model.params["decoder"], new_encoded, rows, names)
            desc = " + ".join(f"{len(h['cells'])}L D={h['start'].shape[1]}" for h in heads)
            resid, exact = gd.gru_decode_fwd_train(heads, "D_resid"), gd.gru_decode_fwd_train(heads)
            torch.cuda.synchronize()
            for (p, lg, hs), (fp, fl, fhs) in zip(resid, exact):
                if not (torch.equal(p, fp) and torch.equal(lg, fl)):
                    raise RuntimeError(f"D resid {call} B={rows}: probs or logits differ from the "
                                       "float32 build's")
                if not all(x.dtype == bf and torch.equal(x, y.to(bf)) for x, y in zip(hs, fhs)):
                    raise RuntimeError(f"D resid {call} B={rows}: a stored h sequence is not the "
                                       "float32 build's rounded to bf16")
            limits = [lim for h in heads for lim in [H_ATOL, LOGITS_ATOL] + [BF16_OUT] * len(h["cells"])]
            plain_d = lambda h=heads: fwd_flat([gd.gru_decode_train_reference(  # noqa: E731
                x["cells"], x["out"], x["init"], x["start"], x["T"], x["out_activation"], bf)
                for x in h])
            dinputs = [[h["cells"], h["out"], h["init"], h["start"]] for h in heads]
            out = run(f"D resid {call} ({desc})", lambda h=heads: fwd_flat(gd.gru_decode_fwd_train(h, "D_resid")),
                      plain_d, limits, **d_work(heads), inputs=dinputs)
            # its per-block route (the first design, 8 rows a block: every
            # head of the call in one launch) on the same heads
            blk = run(f"D resid per-block route {call} ({desc})",
                      lambda h=heads: fwd_flat(d_block(h, "D_resid")), plain_d, limits,
                      **d_work(heads), inputs=dinputs)
            if timed:
                results["gru_decode_train_resid"][call] = out
                results["gru_decode_train_chain_resid"][call] = out
                results["gru_decode_train_block_resid"][call] = blk
            with_residuals(heads, bf)
            grad = (rel, RESID_REL_L2)
            limits = [lim for h in heads for lim in
                      [grad] * (1 + len(h["cells"])) + [H_ATOL] * len(h["cells"])
                      + [grad] * (len(h["cells"]) + 1)]
            out = run(f"E resid {call}", lambda h=heads: bwd_flat(gd.gru_decode_bwd(h, "E_resid")),
                      lambda h=heads: bwd_flat([plain_e(x) for x in h]), limits,
                      **e_work(heads), inputs=[[h[k] for k in ("cells", "out", "init", "start", "probs", "h_seqs",
                                              "g_probs", "g_logits")] for h in heads])
            for phase, res in e_phase_checks(run, f"{call} B={rows}", heads, "E_resid").items():
                if timed:
                    results[phase + "_resid"][call] = res
            if timed:
                results["gru_decode_bwd_resid"][call] = out
                # the control: E's float32 build fed the unrounded sequences
                want = bwd_flat([plain_e(x) for x in heads])
                f32 = [dict(h, h_seqs=gd.gru_decode_train_reference(
                    h["cells"], h["out"], h["init"], h["start"], h["T"], h["out_activation"])[2])
                    for h in heads]
                wrong = bwd_flat(gd.gru_decode_bwd(f32))
                # the largest share of either limit it reaches (over 1: outside)
                found[f"E fed the float32 sequences, {call}"] = max(
                    max((g - w).abs().max().item() / rel(w), rel_l2(g, w) / RESID_REL_L2)
                    for g, w, lim in zip(wrong, want, limits) if lim is grad)
            for k, h in enumerate(heads):
                pairs = head_weight_grads(h, plain_e(h))
                n = len(pairs) + 1 + len(h["cells"])
                # dWo (and notes layer 2's dW) over the rounded sequences:
                # W's bf16 build; the rest float32
                out = run(f"W resid {call} head {k}", lambda p=pairs: run_weight_grads(p, True),
                          lambda p=pairs: run_weight_grads(p, False), [rel] * n,
                          **tf32_work(sum(2 * a.shape[0] * a.shape[1] * b.shape[1]
                                          for a, b in pairs), 2),
                          inputs=pairs, library_fn=lambda p=pairs: cublas_pairs(p))
                if timed:
                    results["grad_reduce_resid"][f"{call} head {k}"] = out
            autograd_check(f"D+E+W resid grads {call} B={rows}", heads, rel,
                           ("D_resid", "E_resid"))

    # (1b) decode_residual_bf16 at H = 448, B = 32, off the narrow route: the
    # multi-head call runs on the card (D resid's chain, E resid's chain)
    cfg = Config(lstm_size=448, decode_residual_bf16=True, batch_size=32)
    if not port_vae._multihead(cfg, _layout.config_route(cfg), 32, on_card=True):
        raise RuntimeError("decode_residual_bf16 at H = 448, B = 32 does not take the multi-head "
                           "call on the card")
    model = MidiVAE(cfg).to(dev)
    z = 0.5 * torch.randn(32, cfg.latent_dim, generator=gen, device=dev)
    heads = heads_of(cfg, model.params["decoder"], torch.cat([z, torch.roll(z, 1, 0)], dim=-1), 32,
                     ("notes", "velocity"))
    limits = [lim for h in heads for lim in [H_ATOL, LOGITS_ATOL] + [BF16_OUT] * len(h["cells"])]
    check("D resid notes+velocity H=448 B=32", lambda: fwd_flat(gd.gru_decode_fwd_train(
        heads, "D_resid")), lambda: fwd_flat([gd.gru_decode_train_reference(
            x["cells"], x["out"], x["init"], x["start"], x["T"], x["out_activation"], bf)
            for x in heads]), limits)
    with_residuals(heads, bf)
    autograd_check("D+E+W resid grads notes+velocity H=448 B=32", heads, rel,
                   ("D_resid", "E_resid"))
    print("[residual kernels] decode_residual_bf16 at H = 448, B = 32 runs rows 5 and 6 on the "
          "card (D resid's chain, E resid's chain), at the limits of B = 256")

    # (2) rows 7 and 8 in bf16 at H = 512: the instrument head at B = 128
    cfg = Config(lstm_size=512, compute_dtype="bfloat16", batch_size=128)
    model = MidiVAE(cfg).to(dev)
    dec = _cast_tree(model.params, bf)["decoder"]
    for rows in (cfg.batch_size, RAGGED):
        timed = rows == cfg.batch_size
        run = compare if timed else check
        batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, rows, 40).items()}
        with torch.no_grad():
            z = model.encode(batch).to(bf)
        new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
        (head,) = heads_of(cfg, dec, new_encoded, rows, ("instrument",), bf)
        n, T = len(head["cells"]), head["T"]
        tag = f"instrument (1L D={head['start'].shape[1]} T={T}) B={rows}"
        out = run(f"D wide bf16 (row 7) {tag}",
                  lambda: fwd_flat(gd.gru_decode_fwd_train_wide([head])),
                  lambda: fwd_flat([gd.gru_decode_train_reference(
                      head["cells"], head["out"], head["init"], head["start"], T,
                      head["out_activation"])]), [BF16_OUT] * (2 + n), **d_work([head]),
                  inputs=[head["cells"], head["out"], head["init"], head["start"]])
        if timed:
            results["gru_decode_train_rows78"]["instrument"] = out
        # the notes head of this step (row 13 in bf16: D wide bf16's chain) at
        # the same batch
        (notes,) = heads_of(cfg, dec, new_encoded, rows, ("notes",), bf)
        check(f"D wide bf16 (row 13) notes B={rows}",
              lambda: fwd_flat(gd.gru_decode_fwd_train_wide([notes])),
              lambda: fwd_flat([gd.gru_decode_train_reference(
                  notes["cells"], notes["out"], notes["init"], notes["start"], notes["T"],
                  notes["out_activation"])]), [BF16_OUT] * (2 + len(notes["cells"])))
        with_residuals([head], None)
        out = run(f"E wide row8 bf16 {tag}",
                  lambda: bwd_flat(gd.gru_decode_bwd_wide([head], "E_wide_row8_bf16")),
                  lambda: bwd_flat([plain_e(head)]),
                  [BF16_OUT] * (1 + n) + [H_ATOL] * n + [BF16_OUT] * (n + 1),
                  **e_work([head]),
                  inputs=[head[k] for k in ("cells", "out", "init", "start", "probs", "h_seqs",
                                            "g_probs", "g_logits")])
        if timed:
            results["gru_decode_bwd_wide_row8_bf16"]["instrument"] = out
        for phase, res in e_phase_checks(run, tag, [head], "E_wide_row8_bf16").items():
            if timed:
                results[phase.removesuffix("_bf16") + "_rows78_bf16"]["instrument"] = res
        # the streams W sums: unrounded (row 8), within STREAM_REL_L2 of the
        # plain version's, where row 14's rounded build lands over it
        ke = gd.gru_decode_bwd_wide([head], "E_wide_row8_bf16")[0]
        r14 = gd.gru_decode_bwd_wide([head])[0]
        pe = plain_e(head)
        streams = [("dlogits", None)] + [(f"da{k + 1}", k) for k in range(n)]
        pick = lambda o, i: o["dlogits"] if i is None else o["da"][i]  # noqa: E731
        if all(torch.equal(pick(ke, i), pick(ke, i).to(bf).float()) for _, i in streams):
            raise RuntimeError(f"E wide row8 bf16 {tag}: every stream holds bf16 values")
        for what, i in streams:
            err = rel_l2(pick(ke, i), pick(pe, i))
            if not err <= STREAM_REL_L2:
                raise RuntimeError(f"E wide row8 bf16 {tag}: its {what} lies {err:.3e} from the "
                                   f"plain version's, over {STREAM_REL_L2:.1e}")
            if timed:
                found[f"E wide row8 instrument {what} (the kernel)"] = err
                found[f"E wide row8 instrument {what}: row 14's rounded build"] = rel_l2(
                    pick(r14, i), pick(pe, i))
        pairs = head_weight_grads(head, pe)
        out = run(f"W bf16 rows 7, 8 {tag} (unrounded streams)",
                  lambda p=pairs: run_weight_grads(p, True),
                  lambda p=pairs: run_weight_grads(p, False), [(rel, W_REL_L2)] * (len(pairs) + 1 + n),
                  **tf32_work(sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in pairs), 2),
                  inputs=pairs, library_fn=lambda p=pairs: cublas_pairs(p))
        if timed:
            results["grad_reduce_rows78_bf16"]["instrument"] = out
        autograd_check(f"D+E+W rows 7, 8 bf16 grads {tag}", [head], BF16_GRAD_OP,
                       ("D_wide_bf16", "E_wide_row8_bf16"))
    limits = {k: (1.0 if k.startswith("E fed") else STREAM_REL_L2) for k in found
              if k.startswith("E fed") or k.endswith("rounded build")}
    print("[residual kernels] the controls (E fed the float32 sequences: its largest share of "
          "the limits rel() and RESID_REL_L2; the streams: relative L2): " + ", ".join(
        f"{k} {v:.3e}" + (f" (must exceed {limits[k]:.1e})" if k in limits else "")
        for k, v in found.items()))
    for what, lim in limits.items():
        if not found[what] > lim:
            raise RuntimeError(f"the control {what} lands at {found[what]:.3e}, inside {lim:.1e}")
    print(f"[residual kernels] D and E resid, the wide D and E's row-8 build in bf16 and W agree "
          f"with their plain versions at B = {B}, 128 and {RAGGED}; the autograd ops' gradients "
          "with the plain backward")
    return results


def phase_gru1024_kernels():
    """GRU(1024): every kernel the step and the serving path run at
    Config(lstm_size=1024) and its bf16 twin (T 64, H 1024), at B = 256
    (timed, with bounds) and B = 5, each against its plain version, as the
    phases at 512 hold them (TF32 off; phase_wide_kernels' and
    phase_bf16_wide_kernels' limits). float32 (the wide route: rows 11 to
    14, the JAX package's rows at this width; the notes head, which it scans
    in XLA, on the same wide D and E): per encoder layer F (its tensor-core
    instance, the slice streamed), G and its phases (the xp gate pre-pass,
    C's chain with U^T streamed), W's dU; the wide D and E (and E's phases)
    on each head alone, W over each head's products, D + E + W against
    autograd; A on the four layers and B on the three heads, also at one
    song (B = 16). bf16: per layer X (F's tensor-core instance in its bf16
    build), G bf16 and its phases, W's dU from G's float32 gate grads; the
    instrument head (the notes head is the XLA scan there, the velocity head
    float32) through the wide D and E in bf16 (E's per-segment instance: its
    H + 64 wide partial) and W over E's rounded streams. The layer ops'
    gradients against the plain backward at B = 5. Every bound prices each
    product at the card's best rate for its operand types (f_work, g_work,
    d_work; A's recurrence, B's products and E's chain and readout too: a
    float32 product as three TF32 products)."""
    import collections

    import torch

    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.models.rnn import init_decoder_states
    from midi_vae_tpu_torch.models.vae import MidiVAE, _cast_tree
    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops import gru_layer as gl
    from midi_vae_tpu_torch.ops.grad_reduce import (
        grad_reduce,
        grad_reduce_reference,
        gru_u_grad,
        gru_weight_grads,
    )

    H = 1024
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1024)
    # timed at fewer runs than the phases at 512: the plain versions take up
    # to 60 ms a call here
    timed_run = functools.partial(compare, reps=7, plain_reps=3)
    tm = lambda a: a.transpose(0, 1).contiguous()  # noqa: E731
    results = collections.defaultdict(dict)

    def plain_u(hprev, rh, da):
        n = hprev.shape[0] * hprev.shape[1]
        da = da.reshape(n, 3 * H)
        return torch.cat([grad_reduce_reference(hprev.reshape(n, H), da[:, : 2 * H])[0],
                          grad_reduce_reference(rh.reshape(n, H), da[:, 2 * H :])[0]], 1)

    def cublas_u(hprev, rh, da):
        n = hprev.shape[0] * hprev.shape[1]
        da = da.reshape(n, 3 * H)
        return torch.cat([hprev.reshape(n, H).t() @ da[:, : 2 * H],
                          rh.reshape(n, H).t() @ da[:, 2 * H :]], 1)

    def layers_of(batch, enc, rows, dtype):
        """(name, x, params, return_sequences, xp) of the four encoder layers,
        xp = x @ W + b in the model's dtype, notes L2 fed L1's plain sequence."""
        h0 = torch.zeros(rows, H, device=dev, dtype=dtype)

        def xp_of(x, p):
            T = x.shape[0]
            return (x.reshape(T * rows, -1) @ p["w"] + p["b"]).reshape(T, rows, 3 * H)

        out = []
        with torch.no_grad():
            p1 = enc["notes_rnn"][0]
            xp1 = xp_of(tm(batch["X"]), p1)
            seq1 = gl.gru_layer_xp_reference(xp1, h0, p1["u"].detach())
            for name, x, p, rs in (("notes_l1", tm(batch["X"]), p1, True),
                                   ("notes_l2", seq1, enc["notes_rnn"][1], False),
                                   ("instrument", tm(batch["I"]), enc["inst_rnn"][0], False),
                                   ("velocity", tm(batch["V"]), enc["vel_rnn"][0], False)):
                out.append((name, x, {k: p[k].detach() for k in "wbu"}, rs, xp_of(x, p)))
        return h0, out

    # ---- float32: F, G, W, the wide D and E, A and B
    cfg = Config(lstm_size=H)
    model = MidiVAE(cfg).to(dev)
    enc, dec = model.params["encoder"], model.params["decoder"]
    for rows in (B, RAGGED):
        timed = rows == B
        run = timed_run if timed else check
        batch = {k: torch.as_tensor(v, device=dev) for k, v in random_batch(cfg, rows, 10).items()}
        h0, layers = layers_of(batch, enc, rows, torch.float32)
        for name, x, p, rs, xp in layers:
            u, T = p["u"], x.shape[0]
            tag = f"H=1024 {name}"
            out = run(f"F {tag} xp{tuple(xp.shape)}", lambda a=(xp, h0, u): gl.gru_layer_xp(*a),
                      lambda a=(xp, h0, u): gl.gru_layer_xp_reference(*a), [H_ATOL],
                      **f_work(T, rows, H), inputs=[xp, h0, u])
            if timed:
                results["gru1024_xp_fwd"][name] = out
            with torch.no_grad():
                seq = gl.gru_layer_xp_reference(xp, h0, u)
            g = torch.randn(seq.shape if rs else seq.shape[1:], generator=gen, device=dev)
            args = (xp, seq, h0, g if rs else None, None if rs else g, u)
            out = run(f"G {tag} rs={rs}", lambda a=args: gl.gru_layer_xp_bwd(*a)[1:],
                      lambda a=args: gl.gru_layer_xp_bwd_reference(*a)[1:], [rel, rel, H_ATOL],
                      **g_work(xp, u), inputs=[t for t in args if t is not None])
            if timed:
                results["gru1024_xp_bwd"][name] = out
            for phase, res in g_phase_checks(run, f"{tag} rs={rs}", args).items():
                if timed:
                    results[phase.replace("gru_", "gru1024_", 1)][name] = res
            _dxp, _dh0, da, rh = gl.gru_layer_xp_bwd_reference(*args)
            hprev = torch.cat([h0[None], seq[:-1]])
            uargs = (hprev, rh, da)
            out = run(f"W {tag} dU", lambda a=uargs: gru_u_grad(*a), lambda a=uargs: plain_u(*a),
                      [rel], **tf32_work(2 * T * rows * u.numel()), inputs=uargs,
                      library_fn=lambda a=uargs: cublas_u(*a))
            if timed:
                results["gru1024_grad_reduce"][f"encoder {name}"] = out
            else:  # F + G + W against autograd through the plain forward
                leaves = [t.clone().requires_grad_() for t in (xp, h0, u)]
                got = torch.autograd.grad(gl.gru_layer_train(*leaves, rs), leaves, g)
                plain = gl.gru_layer_xp_reference(*leaves)
                want = torch.autograd.grad(plain if rs else plain[-1], leaves, g)
                check(f"F+G+W grads {tag} B={rows}", lambda: got, lambda: want, [rel] * 3)
        with torch.no_grad():
            z = model.encode(batch)
        new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
        calls = _decode_train_heads(cfg, dec, new_encoded, rows, dev, wide=True)
        sub = collections.defaultdict(dict)
        check_decode_calls(calls, gen, run, timed, sub, wide=True, block=False, best=True)
        for k, v in sub.items():
            results[k.replace("gru_", "gru1024_", 1).replace("grad_reduce_wide",
                                                             "gru1024_grad_reduce")].update(v)
        # the serving kernels: A on the encoder layers, B on the heads
        with torch.inference_mode():
            for song in ((rows, 16) if timed else (rows,)):
                for name, x, p, rs, _xp in layers:
                    args = (x[:, :song].contiguous(), h0[:song], p["w"], p["b"], p["u"], "tanh", rs)
                    out = (run if song == rows else check)(
                        f"A H=1024 {name} rs={rs} B={song}", lambda a=args: gl.gru_layer(*a),
                        lambda a=args: gl.gru_layer_reference(*a), [H_ATOL],
                        **a_work(x.shape[0], song, p["w"], p["u"], best=True), inputs=args[:5])
                    if timed and song == rows:
                        results["gru1024_layer"][name] = out
                for name, d, T, out_act in (
                        ("notes", cfg.output_dim, cfg.output_length, cfg.activation),
                        ("velocity", 1, cfg.meta_velocity_length, cfg.meta_velocity_activation),
                        ("instrument", cfg.meta_instrument_dim, cfg.meta_instrument_length,
                         cfg.meta_instrument_activation)):
                    h = dec[name]
                    states = [s_[0][:song] for s_ in init_decoder_states(
                        h["init"], new_encoded, cfg.cell_type, cfg.lstm_state_activation)]
                    args = (list(h["cells"]), h["out"], states, torch.zeros(song, d, device=dev),
                            T, "tanh", out_act)
                    out = (run if song == rows else check)(
                        f"B H=1024 {name} B={song}", lambda a=args: gd.gru_decode(*a),
                        lambda a=args: gd.gru_decode_reference(*a), [H_ATOL, LOGITS_ATOL],
                        **tf32_work(decode_flops(T, song, h["cells"], h["out"]["w"])),
                        inputs=args[:4])
                    if timed and song == rows:
                        results["gru1024_decode"][name] = out
    del model, enc, dec
    torch.cuda.empty_cache()

    # ---- bf16: X, G bf16, W, the wide D and E in bf16 on the instrument head
    cfg = Config(lstm_size=H, compute_dtype="bfloat16")
    model = MidiVAE(cfg).to(dev)
    params = _cast_tree(model.params, bf)
    enc, dec = params["encoder"], params["decoder"]

    def cot(shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    for rows in (B, RAGGED):
        timed = rows == B
        run = timed_run if timed else check
        batch = {k: torch.as_tensor(v, device=dev).to(bf)
                 for k, v in random_batch(cfg, rows, 11).items()}
        h0, layers = layers_of(batch, enc, rows, bf)
        for name, x, p, rs, xp in layers:
            u, T = p["u"], x.shape[0]
            tag = f"H=1024 {name}"
            fargs = (xp, h0, u)
            out = run(f"X bf16 (row 11) {tag} xp{tuple(xp.shape)}",
                      lambda a=fargs: gl.gru_layer_xp(*a),
                      lambda a=fargs: gl.gru_layer_xp_reference(*a), [BF16],
                      **x_work(T, rows, H), inputs=fargs)
            if timed:
                results["gru1024_encoder_scan"][name] = out
            with torch.no_grad():
                seq = gl.gru_layer_xp_reference(*fargs)
            g = cot(seq.shape if rs else seq.shape[1:])
            gargs = (xp, seq, h0, g if rs else None, None if rs else g, u)
            out = run(f"G bf16 {tag} rs={rs}", lambda a=gargs: gl.gru_layer_xp_bwd(*a),
                      lambda a=gargs: gl.gru_layer_xp_bwd_reference(*a),
                      [BF16_OUT, BF16_OUT, rel, H_ATOL], **g_work(xp, u),
                      inputs=[t for t in gargs if t is not None])
            if timed:
                results["gru1024_xp_bwd_bf16"][name] = out
            for phase, res in g_phase_checks(run, f"{tag} rs={rs}", gargs).items():
                if timed:
                    results[phase.replace("gru_", "gru1024_", 1)][name] = res
            dxp, dh0_plain, da, rh = gl.gru_layer_xp_bwd_reference(*gargs)
            err = rel_l2(gl.gru_layer_xp_bwd(*gargs)[2], da)
            if not err <= STREAM_REL_L2:
                raise RuntimeError(f"G bf16 {tag}: the gate grads lie {err:.3e} from the plain "
                                   f"version's, over {STREAM_REL_L2:.1e}")
            hprev = torch.cat([h0[None], seq[:-1]])
            uargs = (hprev, rh, da)
            out = run(f"W bf16 {tag} dU", lambda a=uargs: gru_u_grad(*a),
                      lambda a=uargs: plain_u(*a), [(rel, W_REL_L2)],
                      **tf32_work(2 * T * rows * u.numel(), 2), inputs=uargs,
                      library_fn=lambda a=uargs: cublas_u(a[0].float(), *a[1:]))
            if timed:
                results["gru1024_grad_reduce_bf16"][f"encoder {name}"] = out
            else:
                leaves = [t.clone().requires_grad_() for t in fargs]
                got = torch.autograd.grad(gl.gru_layer_train(*leaves, rs), leaves, g)
                check(f"X+G+W bf16 grads {tag} B={rows}", lambda: got,
                      lambda: (dxp, dh0_plain, plain_u(*uargs).to(bf)), [BF16_GRAD_OP] * 3)
        with torch.no_grad():
            z = model.encode({k: v.float() for k, v in batch.items()}).to(bf)
        new_encoded = torch.cat([z, torch.roll(z, 1, 0)], dim=-1)
        name, d, T, out_act = ("instrument", cfg.meta_instrument_dim, cfg.meta_instrument_length,
                               cfg.meta_instrument_activation)
        h = dec[name]
        with torch.no_grad():
            states = init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                         cfg.lstm_state_activation)
        head = {"cells": [{k: c[k].detach() for k in "wub"} for c in h["cells"]],
                "out": {k: h["out"][k].detach() for k in "wb"},
                "init": [s_[0].detach() for s_ in states],
                "start": torch.zeros(rows, d, device=dev, dtype=bf), "T": T,
                "out_activation": out_act}
        n = len(head["cells"])
        tag = f"H=1024 {name} ({n}L D={d} T={T} {out_act})"

        def kernel_d(h_=head):
            probs, logits, h_seqs = gd.gru_decode_fwd_train_wide([h_])[0]
            return probs, logits, *h_seqs

        def plain_d(h_=head):
            probs, logits, h_seqs = gd.gru_decode_train_reference(
                h_["cells"], h_["out"], h_["init"], h_["start"], h_["T"], h_["out_activation"])
            return probs, logits, *h_seqs

        out = run(f"D wide bf16 {tag}", kernel_d, plain_d, [BF16_OUT] * (2 + n),
                  **d_work([head]), inputs=[head["cells"], head["out"], head["init"],
                                            head["start"]])
        if timed:
            results["gru1024_decode_train_wide_bf16"][name] = out
        probs, _logits, *h_seqs = plain_d()
        head.update(probs=probs, h_seqs=h_seqs, g_probs=cot(probs.shape), g_logits=cot(probs.shape))

        def plain_e(wide=True):
            return gd.gru_decode_bwd_reference(head["cells"], head["out"], head["init"],
                                               head["start"], head["probs"], head["h_seqs"],
                                               head["g_probs"], head["g_logits"],
                                               head["out_activation"], wide)

        bwd_flat = lambda o: (o["dlogits"], *o["da"], *o["rh"], *o["d_init"], o["d_start"])  # noqa: E731
        out = run(f"E wide bf16 {tag}", lambda: bwd_flat(gd.gru_decode_bwd_wide([head])[0]),
                  lambda: bwd_flat(plain_e()),
                  [BF16_OUT] * (1 + n) + [H_ATOL] * n + [BF16_OUT] * (n + 1),
                  **e_work([head], best=True),
                  inputs=[head[k] for k in ("cells", "out", "init", "start", "probs", "h_seqs",
                                            "g_probs", "g_logits")])
        if timed:
            results["gru1024_decode_bwd_wide_bf16"][name] = out
        for phase, res in e_phase_checks(run, tag, [head], "E_wide_bf16", True).items():
            if timed:
                results[phase.replace("gru_", "gru1024_", 1)][name] = res
        ke, pe = gd.gru_decode_bwd_wide([head])[0], plain_e()
        for what, i in (("dlogits", None), *((f"da{k + 1}", k) for k in range(n))):
            kt, pt = ((o["dlogits"] if i is None else o["da"][i]) for o in (ke, pe))
            err = rel_l2(kt, pt)
            if not (torch.equal(kt, kt.to(bf).float()) and err <= STREAM_REL_L2):
                raise RuntimeError(f"E wide bf16 {tag}: its {what} lies {err:.3e} from the plain "
                                   f"version's (limit {STREAM_REL_L2:.1e}) or is not bf16")
        g_ = plain_e()
        wset = (h_seqs[-1].reshape(T * rows, H), g_["dlogits"].reshape(T * rows, d),
                [(h_seqs[i - 1] if i else torch.cat([head["start"][None], probs[:-1]]),
                  torch.cat([head["init"][i][None], h_seqs[i][:-1]]), g_["rh"][i], g_["da"][i])
                 for i in range(n)])

        def kernel_w(ws=wset):
            top, dl, cells = ws
            dwo = torch.empty(H, dl.shape[1], device=dev)
            dbo = torch.empty(dl.shape[1], device=dev)
            grad_reduce(top, dl, dwo, dbo)
            return (dwo, dbo, *(t for c in cells for t in gru_weight_grads(*c)))

        def plain_w(ws=wset):
            top, dl, cells = ws
            return (*grad_reduce_reference(top, dl, True),
                    *(t for c in cells for t in plain_weight_grads(*c)))

        def library_w(ws=wset):
            top, dl, cells = ws
            top = top.float()
            return (top.t() @ dl, dl.sum(0),
                    *(t for c in cells for t in cublas_weight_grads(*(x.float() for x in c))))

        out = run(f"W bf16 {tag} head (rounded streams)", kernel_w, plain_w,
                  [(rel, W_REL_L2)] * (2 + 3 * n),
                  **tf32_work(2 * T * rows * H * d + sum(weight_grad_flops(c[0], c[1])
                                                         for c in wset[2]), 2),
                  inputs=list(wset), library_fn=library_w)
        if timed:
            results["gru1024_grad_reduce_bf16"][f"decode {name}"] = out
        else:  # D + E + W against the plain backward
            leaves = [t.clone().requires_grad_() for t in gd._flatten_head(head)]
            lhead = dict(head, **gd._unflatten_heads([(n, out_act, T)], leaves)[0])
            got_p, got_l = gd._decode_heads_train([lhead], ("D_wide_bf16", "E_wide_bf16"))[0]
            got = torch.autograd.grad((got_p, got_l), leaves, (head["g_probs"], head["g_logits"]))
            want = plain_decode_vjp(head, head["g_probs"], head["g_logits"], wide=True)
            check(f"D+E+W wide bf16 grads {tag} B={rows}", lambda: got, lambda: want,
                  [BF16_GRAD_OP] * len(want))
    del model, params, enc, dec
    torch.cuda.empty_cache()
    print(f"[gru1024 kernels] F, G, W, the wide D and E, A and B in float32 and X, G, W, the "
          f"wide D and E in bf16 agree with their plain versions at H = 1024, B = {B} and "
          f"{RAGGED} (A and B also at one song, B = 16); the layer and decode ops' gradients "
          "with the plain backward")
    return dict(results)


def phase_gru1024_paths(smi):
    """GRU(1024) through the entry points: the train CLI with --set
    lstm_size=1024 (2 epochs and a resume) and the transfer CLI on its run,
    then that run's transfer card against the CPU (argmax agreement); the
    same CLI run in bf16; one f32 training step card against the CPU plain
    path at B = 64 (the JAX package's rows at this width are the same from
    B = 16 to 256) and one bf16 step at B = 256 (250 valid rows, as the
    other bf16 steps: BF16_ACC_ATOL admits one flipped argmax there, not at
    58 rows, where one composer near-tie flips: its margins lie under the
    logits' card - CPU rounding differences, argmax_flips; PERF.md), their
    launch counters exact: every part on its chain, none per block."""
    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.training import checkpoint as ckpt

    paths, steps = {}, {}
    with tempfile.TemporaryDirectory() as work:
        paths["train_1024"] = phase_train_slice(work, ["lstm_size=1024"])
        serving = phase_card_vs_cpu(smi, "GRU", {"lstm_size": H1024},
                                    params=ckpt.load_params(os.path.join(work, "train_run")))
    with tempfile.TemporaryDirectory() as work:
        paths["train_1024_bf16"] = phase_train_slice(
            work, ["lstm_size=1024", "compute_dtype=bfloat16"], "wide1024_bf16")
    for key, overrides in (("wide", {"batch_size": 64}),
                           ("wide1024_bf16", {"compute_dtype": "bfloat16"})):
        steps[key] = phase_train_card_vs_cpu(smi, Config(lstm_size=H1024, **overrides),
                                             PER_TRAIN_STEP[key], f"GRU(1024) {key} train")
        paths[f"step_1024_{key}"] = steps[key]["launches"]
    for path, counts in paths.items():
        off = {k: v for k, v in counts.items() if k.endswith(("_block", "_block_bf16"))}
        if off:
            raise RuntimeError(f"the {path} path took a per-block route: {off}")
        print(f"[routes] {path}: every launch on a chain: " + ", ".join(
            f"{k} {v}" for k, v in sorted(counts.items()) if "chain" in k))
    return paths, steps, serving


def phase_train_step_card(smi, cfg, per_step, label):
    """One training step of ``cfg`` on the card (the batch and noise of
    ``phase_train_card_vs_cpu``): a finite loss and metrics, every gradient
    finite, the launch counters equal to ``per_step``; then its time."""
    import numpy as np
    import torch

    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.tools.profile_train import random_train_batch
    from midi_vae_tpu_torch.training.trainer import VAETrainer

    rows = cfg.batch_size
    params = MidiVAE(cfg).init_params(np.array([0, cfg.seed], np.uint32))
    batch = random_train_batch(cfg, rows, 4, valid=rows - 6)
    noise = (cfg.epsilon_std * np.random.RandomState(5).randn(rows, cfg.latent_dim)).astype(np.float32)
    trainer = VAETrainer(cfg, "cuda")
    state = trainer.new_state(params)
    tb = trainer.to_device(batch)
    reset_counters()
    loss, metrics, grads = trainer.value_and_grad(state, tb, torch.as_tensor(noise, device="cuda"))
    torch.cuda.synchronize()
    launches = read_counters()
    if launches != per_step:
        raise RuntimeError(f"{label}: one step launched {launches}, expected {per_step}")
    values = [loss.item(), *(v.item() for v in metrics.values())]
    if not (np.all(np.isfinite(values)) and all(torch.isfinite(g).all() for g in grads)):
        raise RuntimeError(f"{label}: loss {values[0]}, metrics or gradients not finite")
    trainer.train_step(state, tb)
    ms = median_ms(lambda: trainer.train_step(state, tb), STEP_REPS)
    steps = rows * cfg.output_length
    print(f"[{label}] one step on the card: loss {values[0]:.4f}, every gradient finite, launches "
          f"{per_step}; training step {ms:.3f} ms (median of {STEP_REPS}, CUDA events) = "
          f"{steps / ms * 1e3:.1f} note-steps/s on {smi}")
    return {"step_ms": ms, "note_steps_per_s": steps / ms * 1e3, "loss": values[0],
            "launches": launches}


def phase_gru_3layer_serving(work, smi):
    """A GRU run with a 3-layer notes head (Config(num_layers_decoder=3),
    seeded init) served through the transfer CLI on 2 authored songs: kernel
    T runs the notes head, 3 cells x 64 steps per call, B the velocity and
    instrument heads; then one transfer batch card against CPU."""
    import io
    from contextlib import redirect_stdout

    import numpy as np

    from midi_vae_tpu_torch import bridge
    from midi_vae_tpu_torch.cli import transfer
    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.data import smf
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.training.checkpoint import save_run

    from midi_vae_tpu_torch.tools import make_demo_corpus as corpus

    cfg = Config(num_layers_decoder=3)
    run = os.path.join(work, "run")
    save_run(run, cfg, bridge.to_tree(MidiVAE(cfg).params))
    songs = os.path.join(work, "songs")
    os.makedirs(songs)
    rng = np.random.RandomState(5)
    inputs = []
    for i in range(2):
        inputs.append(os.path.join(songs, f"song{i}.mid"))
        corpus.make_song(corpus.STYLES["style1"], rng).write(inputs[-1])
    out = os.path.join(work, "out")
    reset_counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = transfer.main(["--model", run, "--input", *inputs, "--to-class", "style2", "--output",
                            out, "--device", "cuda"])
    secs = time.perf_counter() - t0
    launches = read_counters()
    want = fwd_phases({"gru_layer_fwd": 4 * len(inputs), "gru_decode": 2 * len(inputs),
                       "gru_step": 3 * cfg.output_length * len(inputs)})
    if rc != 0 or launches != want:
        raise RuntimeError(f"transfer with a 3-layer notes head: rc {rc}, launches {launches} "
                           f"(expected {want})\n{buf.getvalue()}")
    for path in sorted(os.listdir(out)):
        if not smf.read_midi(os.path.join(out, path)).instruments:
            raise RuntimeError(f"{path} (3-layer notes head) parsed back with no instruments")
    print(f"[3-layer head] transfer CLI on {len(inputs)} songs in {secs:.2f} s; launches "
          f"{launches} (as designed)")
    return launches, phase_card_vs_cpu(smi, "GRU", {"num_layers_decoder": 3})


# the sections of cli.evaluate, in the order Evaluator.run takes them
EVAL_SECTIONS = ("stats", "harmonicity", "medleys", "random_interpolations", "latent_sweep",
                 "chords", "sampling_regions", "pitches", "random_songs", "long_songs",
                 "autoencoding")
GEN_MODES = (("random", []), ("style", []), ("interpolate", []), ("long", []),
             ("random_argmax", ["--sample-method", "argmax"]))


def harness_corpus(work):
    """The authored two-class corpus of the generation and evaluation slices:
    10 songs a style (the seeded shuffle split keeps 2 for the test set)."""
    import numpy as np

    from midi_vae_tpu_torch.tools import make_demo_corpus as corpus

    source = os.path.join(work, "corpus")
    rng = np.random.RandomState(7)
    for style in ("style1", "style2"):
        os.makedirs(os.path.join(source, style))
        for i in range(10):
            corpus.make_song(corpus.STYLES[style], rng).write(
                os.path.join(source, style, f"{style}_{i}.mid"))
    return source


class HarnessCalls:
    """Counts the harness's device calls while it is entered:
    ``GenerationContext.encode_song`` (one encode, kernel A 4 or L 4),
    ``GenerationContext._decode_padded`` (one decode, B 3 or M 3) and each
    judge made by ``make_judge`` (A 2 or L 2 a call), with the
    ``bucket_pow2`` batch of each decode and judge call; with ``rolls``,
    the rolls Y of each ``decode_and_process`` call and the probabilities
    of each judge call, in order."""

    def __init__(self, rolls=False):
        self.encode = self.decode = self.judge = 0
        self.decode_buckets, self.judge_buckets = set(), set()
        self.rolls, self.judged = ([], []) if rolls else (None, None)

    def __enter__(self):
        import numpy as np

        from midi_vae_tpu_torch.data.batching import bucket_pow2
        from midi_vae_tpu_torch.evaluation.generation import GenerationContext
        from midi_vae_tpu_torch.models import classifier

        self._saved = [(GenerationContext, name, getattr(GenerationContext, name))
                       for name in ("encode_song", "_decode_padded", "decode_and_process")]
        self._saved.append((classifier, "make_judge", classifier.make_judge))
        encode, decode, process = (fn for _, _, fn in self._saved[:3])
        make_judge = classifier.make_judge

        def encode_song(ctx, X, *args):
            self.encode += 1
            return encode(ctx, X, *args)

        def decode_padded(ctx, fn, z, *args):
            self.decode += 1
            self.decode_buckets.add(bucket_pow2(np.atleast_2d(z).shape[0]))
            return decode(ctx, fn, z, *args)

        def decode_and_process(ctx, *args, **kwargs):
            out = process(ctx, *args, **kwargs)
            if self.rolls is not None:
                self.rolls.append(out[0])
            return out

        def counted_judge(model):
            predict = make_judge(model)

            def judge(x):
                self.judge += 1
                self.judge_buckets.add(bucket_pow2(len(x)))
                probs = predict(x)
                if self.judged is not None:
                    self.judged.append(probs)
                return probs

            return judge

        GenerationContext.encode_song = encode_song
        GenerationContext._decode_padded = decode_padded
        GenerationContext.decode_and_process = decode_and_process
        classifier.make_judge = counted_judge
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)

    def want(self, cell_type="GRU"):
        """The launches the design implies for the calls counted."""
        layer, decode = SERVING_KERNELS[cell_type]
        return fwd_phases({k: v for k, v in ((layer, 4 * self.encode + 2 * self.judge),
                                             (decode, 3 * self.decode)) if v})


def check_midis(folder, tag):
    """Every .mid under ``folder`` parses back; returns how many."""
    from midi_vae_tpu_torch.data import smf

    n = 0
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".mid"):
                smf.read_midi(os.path.join(dirpath, f))
                n += 1
    if not n:
        raise RuntimeError(f"{tag}: no .mid written under {folder}")
    return n


def seeded_run(work, name, cfg):
    from midi_vae_tpu_torch import bridge
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.training.checkpoint import save_run

    run = os.path.join(work, name)
    save_run(run, cfg, bridge.to_tree(MidiVAE(cfg).params))
    return run


def phase_generation_slice(work, smi):
    """``cli.generate --device cuda`` on a seeded-init ``Config()`` run with
    the authored corpus as ``--source`` (the train split's latents give
    z_std, the style means and the long songs' chain), at the CLI's
    defaults (``--count 4``, ``--length 10``): each mode with the default
    choice sampling, and ``random`` with ``--sample-method argmax``; then an LSTM run (``Config(cell_type="LSTM")``) in ``random``
    mode. Every .mid parses back; the launch counters equal A 4 (L 4) per
    encode and B 3 (M 3) per decode call, every launch on a chain. Returns
    the paths' counters, the decode buckets reached by cell type, each
    mode's wall seconds."""
    import io
    from contextlib import redirect_stdout

    from midi_vae_tpu_torch.cli import generate
    from midi_vae_tpu_torch.config import Config

    source, cache = harness_corpus(work), os.path.join(work, "cache")
    runs = {"GRU": seeded_run(work, "gru_run", Config()),
            "LSTM": seeded_run(work, "lstm_run", Config(cell_type="LSTM"))}
    paths, buckets, seconds = {}, {"GRU": set(), "LSTM": set()}, {}
    for cell_type, (mode, extra) in [("GRU", m) for m in GEN_MODES] + [("LSTM", ("random", []))]:
        tag = f"{mode}{' LSTM' if cell_type == 'LSTM' else ''}"
        out = os.path.join(work, f"gen_{cell_type}_{mode}")
        args = ["--model", runs[cell_type], "--output", out, "--mode", mode.split("_")[0],
                "--source", source, "--cache", cache, "--device", "cuda", *extra]
        reset_counters()
        buf = io.StringIO()
        with HarnessCalls() as calls, redirect_stdout(buf):
            t0 = time.perf_counter()
            rc = generate.main(args)
            seconds[tag] = time.perf_counter() - t0
        launches = read_counters()
        if rc != 0:
            raise RuntimeError(f"cli.generate {tag} returned {rc}\n{buf.getvalue()}")
        n_mid = check_midis(out, f"cli.generate {tag}")
        want = calls.want(cell_type)
        if launches != want or not calls.decode:
            raise RuntimeError(f"cli.generate {tag}: launch counters {launches}, expected {want} "
                               f"({calls.encode} encodes, {calls.decode} decodes)")
        buckets[cell_type] |= calls.decode_buckets
        paths[f"generate_{cell_type.lower()}_{mode}"] = launches
        print(f"[generate] {tag}: {n_mid} .mid that parse back, {calls.encode} encodes, "
              f"{calls.decode} decodes (buckets {sorted(calls.decode_buckets)}), launches "
              f"{launches} (as designed); {seconds[tag]:.2f} s on {smi}")
    return paths, buckets, seconds


def phase_evaluation_slice(work, smi):
    """``cli.evaluate --device cuda`` at ``Config()`` width (seeded init) on
    the authored corpus with GRU judges of all three kinds
    (``write_judges``), over all eleven sections at ``--num-songs 1``:
    results.json parses and its numbers are finite or null, the CSV has a
    row per evaluated song (with its class and its switch pair's columns)
    and the mean row, every .mid parses back, and the launch counters equal
    A 4 per encode + A 2 per judge call and B 3 per decode call, every
    launch on a chain. Prints each section's wall seconds. Returns the
    counters, the decode buckets, the sections' seconds."""
    import csv
    import io
    from contextlib import redirect_stdout

    import numpy as np

    from midi_vae_tpu_torch.cli import evaluate
    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.evaluation.harness import Evaluator

    cfg = Config()
    source = harness_corpus(work)
    run = seeded_run(work, "run", cfg)
    judges = os.path.join(work, "judges")
    write_judges(judges, cfg)
    out = os.path.join(work, "eval")
    if tuple(evaluate.SECTIONS) != EVAL_SECTIONS:
        raise RuntimeError(f"cli.evaluate's sections {evaluate.SECTIONS}")
    # each section's wall seconds (Evaluator.run calls them in turn)
    seconds = {}
    saved = {}
    for name in [n for n in vars(Evaluator) if n.startswith("section_")] + ["_cache_latents"]:
        saved[name] = getattr(Evaluator, name)

        def timed(self, *args, _fn=saved[name], _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(self, *args, **kwargs)
            finally:
                seconds[_name] = seconds.get(_name, 0.0) + time.perf_counter() - t0

        setattr(Evaluator, name, timed)
    reset_counters()
    buf = io.StringIO()
    try:
        with HarnessCalls() as calls, redirect_stdout(buf):
            t0 = time.perf_counter()
            rc = evaluate.main(["--source", source, "--model", run, "--classifiers", judges,
                                "--output", out, "--sections", ",".join(EVAL_SECTIONS),
                                "--num-songs", "1", "--device", "cuda"])
            wall = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(Evaluator, name, fn)
    launches = read_counters()
    log = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"cli.evaluate returned {rc}\n{log}")
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)

    def bad_numbers(tree, where=""):
        if isinstance(tree, dict):
            return [b for k, v in tree.items() for b in bad_numbers(v, f"{where}/{k}")]
        if isinstance(tree, list):
            return [b for i, v in enumerate(tree) for b in bad_numbers(v, f"{where}[{i}]")]
        return [where] if isinstance(tree, float) and not np.isfinite(tree) else []

    want_keys = {"dataset_counts", "program_switch_percentage", "z_mean_train", "z_std_train",
                 "harmonicity", "latent_sweep_best_dims", "latent_sweep_best_peaks",
                 "chord_latents", "sampling_region_scales", "sampling_region_locs",
                 "pitch_latents", "harmonicity_autoencoded", "mean_reconstruction_accuracy",
                 "autoencoding_metrics", "switch_matrix", "signature_mahalanobis"}
    if set(results) != want_keys or bad_numbers(results):
        raise RuntimeError(f"results.json: keys {sorted(set(results) ^ want_keys)} differ, "
                           f"non-finite numbers at {bad_numbers(results)[:5]}")
    with open(os.path.join(out, "evaluation_metrics.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    n_test = results["dataset_counts"]["test_songs_per_class"]
    if len(rows) != sum(n_test) + 1 or rows[-1]["song_name"] != "Mean":
        raise RuntimeError(f"the CSV has {len(rows)} rows for {sum(n_test)} test songs + the mean")
    for row in rows[:-1]:
        C = cfg.classes.index(row["class"])
        pairs = [f"switched_pitch_classifier_accuracy_{C}to{o}" for o in range(cfg.num_classes)
                 if o != C]
        if not all(row.get(p) for p in pairs) or not row.get("original_ensemble_classifier_accuracy"):
            raise RuntimeError(f"CSV row of {row['song_name']} lacks its judges' columns")
    n_mid = check_midis(out, "cli.evaluate")
    want = calls.want("GRU")
    if launches != want:
        raise RuntimeError(f"cli.evaluate: launch counters {launches}, expected {want} "
                           f"({calls.encode} encodes, {calls.decode} decodes, {calls.judge} judge calls)")
    for name in ("harmonicity", "latent_sweep", "chord_evaluation", "pitch_evaluation",
                 "sampling_regions", "autoencoding"):
        if f"section_{name}" not in seconds:
            raise RuntimeError(f"section_{name} did not run")
    print(f"[evaluate] all eleven sections at Config() width with GRU judges: results.json "
          f"({len(results)} keys, every number finite or null), a CSV of {len(rows) - 1} songs + the "
          f"mean, {n_mid} .mid that parse back; {calls.encode} encodes, {calls.decode} decodes "
          f"(buckets {sorted(calls.decode_buckets)}), {calls.judge} judge calls (buckets "
          f"{sorted(calls.judge_buckets)}); launches {launches} (as designed); plots: "
          f"{log.count('plot failed')} failed (matplotlib missing or not), "
          f"{len([f for f in os.listdir(out) if f.endswith('.png')])} written")
    print(f"[evaluate] wall {wall:.2f} s on {smi}; per section (s): " + ", ".join(
        f"{k.removeprefix('section_')} {v:.2f}" for k, v in seconds.items()))
    return launches, calls.decode_buckets, {"wall": wall, **seconds}


def phase_harness_card_vs_cpu(work, smi, buckets):
    """The harness on the card against the CPU plain path: ``decode_batch``
    probabilities of every head at each bucket size the generation and
    evaluation slices reached (``buckets``: cell type -> sizes; seeded
    ``Config()`` models, seeded latents and histories), max |card - CPU| <=
    PROBS_ATOL; then the ``autoencoding`` section over 3 songs of the
    authored corpus (two of class 0, one of class 1, the train split) with
    GRU judges on both devices: the rolls of every decode agree on at least
    MIN_ARGMAX_AGREEMENT of their rows, the probabilities of every judge
    call on windows equal on both devices within JUDGE_ATOL of the CPU's,
    and every accuracy of every row within ACC_ATOL of the CPU's plus the
    share of its call's rows whose argmax differs card vs CPU (seeded judges
    sit near 1 / num_classes, so a row can flip at a near-tie; one flipped
    row moves an accuracy by one row and no more)."""
    import io
    from contextlib import redirect_stdout

    import numpy as np

    from midi_vae_tpu_torch import bridge
    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.data.dataset import import_midi_from_folder
    from midi_vae_tpu_torch.evaluation import EvalSections, Evaluator
    from midi_vae_tpu_torch.evaluation.generation import GenerationContext
    from midi_vae_tpu_torch.models.classifier import ensemble_prediction
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.training.checkpoint import load_classifier

    errs = {}
    for cell_type, sizes in buckets.items():
        cfg = Config(cell_type=cell_type)
        params = bridge.to_tree(MidiVAE(cfg).params)
        ctxs = {d: GenerationContext(cfg, MidiVAE(cfg, params), d) for d in ("cuda", "cpu")}
        for n in sorted(sizes):
            rng = np.random.RandomState(n)
            z = rng.normal(0.0, 0.1, (n, cfg.latent_dim)).astype(np.float32)
            H = rng.normal(0.0, 0.1, (n, cfg.latent_dim)).astype(np.float32)
            card, cpu = (ctxs[d].decode_batch(z, history=H) for d in ("cuda", "cpu"))
            for k in cpu:
                if not np.isfinite(card[k]).all():
                    raise RuntimeError(f"{cell_type} decode_batch at {n}: head {k} not finite")
                errs[(cell_type, n, k)] = float(np.abs(card[k] - cpu[k]).max())
    worst = max(errs.items(), key=lambda kv: kv[1])
    if worst[1] > PROBS_ATOL:
        raise RuntimeError(f"decode_batch card vs CPU: max |dprobs| {worst[1]:.3e} at {worst[0]} > "
                           f"{PROBS_ATOL:.0e}")
    print(f"[harness card vs cpu] decode_batch at buckets " + "; ".join(
        f"{c} {sorted(s)}" for c, s in buckets.items()) + f": max |dprobs| {worst[1]:.3e} "
        f"({worst[0]}; limit {PROBS_ATOL:.0e})")

    cfg = Config()
    params = bridge.to_tree(MidiVAE(cfg).params)
    source = harness_corpus(os.path.join(work, "autoencoding"))
    judge_dir = os.path.join(work, "autoencoding", "judges")
    write_judges(judge_dir, cfg)
    ds = import_midi_from_folder(source, cfg)
    keep = [i for i, c in enumerate(ds.C_train) if c == 0][:2] + \
           [i for i, c in enumerate(ds.C_train) if c == 1][:1]
    for name in ("X", "Y", "I", "V", "D", "T", "C"):
        setattr(ds, f"{name}_train", [getattr(ds, f"{name}_train")[i] for i in keep])
    ds.train_paths = [ds.train_paths[i] for i in keep]
    sections = EvalSections(evaluate_autoencoding_and_stuff=True, save_anything=False)
    metrics, recorded = {}, {}
    for device in ("cuda", "cpu"):
        judges = {k: load_classifier(os.path.join(judge_dir, k)) for k in ("pitch", "velocity",
                                                                           "instrument")}
        with HarnessCalls(rolls=True) as calls, redirect_stdout(io.StringIO()):
            ev = Evaluator(cfg, params, ds, os.path.join(work, f"ae_{device}"), classifiers=judges,
                           test_train_set=True, seed=0, device=device)
            metrics[device] = ev.run(sections, log_fn=lambda s: None)["autoencoding_metrics"]
        recorded[device] = calls
    rolls = {d: calls.rolls for d, calls in recorded.items()}
    judged = {d: calls.judged for d, calls in recorded.items()}
    # per song the decodes in order: the autoencoding, the mix with the
    # previous song (from the second song on), one switch per other class;
    # the judge calls in order: the original, the autoencoded and each
    # switch's windows, each through pitch, velocity, instrument
    kinds = ("pitch", "velocity", "instrument")
    n_stages = 2 + cfg.num_classes - 1
    per_song = [1 + (i > 0) + (cfg.num_classes - 1) for i in range(len(keep))]
    if len(rolls["cuda"]) != sum(per_song) or len(rolls["cpu"]) != sum(per_song):
        raise RuntimeError(f"autoencoding made {len(rolls['cuda'])} and {len(rolls['cpu'])} decodes, "
                           f"expected {sum(per_song)}")
    if len(judged["cuda"]) != len(judged["cpu"]) or \
            len(judged["cpu"]) != len(keep) * n_stages * len(kinds):
        raise RuntimeError(f"autoencoding made {len(judged['cuda'])} and {len(judged['cpu'])} judge "
                           f"calls over {len(keep)} songs")
    roll_flips = [int(np.sum(np.any(a != b, axis=1))) for a, b in zip(rolls["cuda"], rolls["cpu"])]
    total = sum(len(a) for a in rolls["cpu"])
    agree = 1.0 - sum(roll_flips) / total
    # Each accuracy is the share of its call's rows whose argmax is the
    # song's class, so card and CPU differ by at most the share of that
    # call's rows whose argmax differs (judge or ensemble rows; for the
    # pitch reconstruction accuracy, the autoencoding's flipped roll rows
    # over the song's notes): every accuracy is held within ACC_ATOL plus
    # that share. A judge's probabilities are held within JUDGE_ATOL where
    # its windows are equal on both devices (the original song's, and those
    # of a decode whose rolls agree row for row).
    allow = {}  # (row, key) -> the share of the accuracy's rows that flipped
    judge_err, judge_held, judge_flips = 0.0, 0, []  # flips: the CPU's top-2 margin

    def flipped_share(g, w):
        rows = g.argmax(1) != w.argmax(1)
        top2 = np.sort(w, axis=1)[:, -2:]
        judge_flips.extend((top2[:, 1] - top2[:, 0])[rows].tolist())
        return float(rows.mean())

    at = 0
    for song, n_decodes in enumerate(per_song):
        row = metrics["cpu"][song]
        C = cfg.classes.index(row["class"])
        targets = [o for o in range(cfg.num_classes) if o != C]
        decode_of = [None, at] + [at + n_decodes - len(targets) + t for t in range(len(targets))]
        allow[(song, "pitch_reconstruction_accuracy")] = \
            roll_flips[at] / max(row["total_original_notes"], 1)
        pair_shares = {}
        for t in range(n_stages):
            j = (song * n_stages + t) * len(kinds)
            calls = {d: judged[d][j:j + len(kinds)] for d in ("cuda", "cpu")}
            if decode_of[t] is None or not roll_flips[decode_of[t]]:
                judge_err = max([judge_err] + [float(np.abs(g - w).max())
                                               for g, w in zip(calls["cuda"], calls["cpu"])])
                judge_held += len(kinds)
            shares = {kind: flipped_share(g, w) for kind, g, w in zip(kinds, *calls.values())}
            # the original song's one instrument matrix judges every window
            ens = [ensemble_prediction(p_, np.repeat(i_, len(p_) // len(i_), axis=0), v_)
                   for p_, v_, i_ in calls.values()]
            shares["ensemble"] = flipped_share(*ens)
            for name, share in shares.items():
                if t < 2:
                    allow[(song, f"{('original', 'autoencoded')[t]}_{name}_classifier_accuracy")] = share
                else:
                    allow[(song, f"switched_{name}_classifier_accuracy_{C}to{targets[t - 2]}")] = share
                    pair_shares.setdefault(name, []).append(share)
        for name, shares in pair_shares.items():
            allow[(song, f"switched_{name}_classifier_accuracy")] = float(np.mean(shares))
        at += n_decodes
    # the mean row averages each key over the songs that have it
    mean = len(keep)
    for key in metrics["cpu"][mean]:
        if "accuracy" in key:
            songs = [s_ for s_ in range(mean) if key in metrics["cpu"][s_]]
            allow[(mean, key)] = float(np.mean([allow.get((s_, key), np.inf) for s_ in songs]))
    diffs, unaccounted = {}, []
    for r, (g, w) in enumerate(zip(metrics["cuda"], metrics["cpu"])):
        if sorted(g) != sorted(w):
            raise RuntimeError(f"autoencoding row {r}: columns differ card vs CPU")
        for key, value in w.items():
            if "accuracy" in key:
                diffs[(r, key)] = abs(g[key] - value)
                if not np.isfinite(allow.get((r, key), np.inf)):
                    unaccounted.append((w["song_name"], key))
    if unaccounted or len(metrics["cpu"]) != mean + 1:
        raise RuntimeError(f"autoencoding: {len(metrics['cpu'])} rows for {len(keep)} songs; "
                           f"accuracies no judge call or decode gives: {unaccounted[:5]}")
    exact = [d for k, d in diffs.items() if allow[k] == 0.0]
    over = {k: d for k, d in diffs.items() if d > ACC_ATOL + allow[k]}
    worst_exact = max(exact, default=0.0)
    worst_excess = max(d - allow[k] for k, d in diffs.items())
    if agree < MIN_ARGMAX_AGREEMENT or judge_err > JUDGE_ATOL or over:
        raise RuntimeError(f"autoencoding card vs CPU: rolls agree on {agree:.5f} of {total} rows "
                           f"(limit {MIN_ARGMAX_AGREEMENT}), judge probs {judge_err:.3e} (limit "
                           f"{JUDGE_ATOL:.0e}), accuracies over ACC_ATOL + their flipped share: "
                           f"{ {k: (d, allow[k]) for k, d in list(over.items())[:5]} }")
    print(f"[harness card vs cpu] autoencoding over {len(keep)} songs with GRU judges: rolls agree "
          f"on {agree:.5f} of {total} rows (flipped per decode {roll_flips}); every one of "
          f"{len(diffs)} accuracies held: {len(exact)} with no flipped row at max |d accuracy| "
          f"{worst_exact:.3e} (limit {ACC_ATOL:.0e}), {len(diffs) - len(exact)} within ACC_ATOL + "
          f"the share of their rows that flipped (largest share "
          f"{max(allow[k] for k in diffs):.3e}, worst |d| - share {worst_excess:.3e}); "
          f"{len(judged['cpu'])} judge calls, {judge_held} on equal windows within max |dprobs| "
          f"{judge_err:.3e} (limit {JUDGE_ATOL:.0e}); {len(judge_flips)} argmax flips of judge and "
          f"ensemble rows at CPU margins {[float(f'{m:.3e}') for m in judge_flips[:8]]}")
    return {"max_abs_dprobs": worst[1], "autoencoding_rows_agreement": agree,
            "accuracies": len(diffs), "accuracies_no_flip": len(exact),
            "autoencoding_max_abs_dacc_no_flip": worst_exact,
            "autoencoding_worst_dacc_minus_share": worst_excess,
            "judges_max_abs_dprobs": judge_err, "judge_calls_held": judge_held,
            "judge_argmax_flips": len(judge_flips)}


def kernel_registers(registers, letter):
    """ptxas's registers and spills of kernel ``letter``'s build; for N's,
    R's, L's, A's and G's ops those of each of their phases (the per-block
    routes of L, A, X and G are builds "L", "A", "X" and "G" of the route
    chooser)."""
    key = letter.replace(" ", "_")
    aliases = {"L_block": "L", "L_block_bf16": "L_bf16", "A_block": "A", "A_block_bf16": "A_bf16",
               "X_block": "X", "G_block": "G", "G_block_bf16": "G_bf16", "M_block": "M"}
    if key in aliases:
        return registers[aliases[key]]
    if key in ("B", "X", "M"):  # the chain and the per-block route
        return {"chain": registers[f"{key}_chain"], "block": registers[key]}
    # F's chain (A's instances in F's library, the tensor-core one) and D's
    # (B's FFMA training instances, the tensor-core one; D resid: its FFMA
    # instance alone), each beside its per-block route
    # (the op, its chain's name, its per-block route's name): chain instances
    routes = {("F", "F_chain", "F_block"): ("F_chain", "F_chain_tc"),
              ("D_wide", "D_wide_chain", "D_wide_block"): ("D_wide_chain", "D_wide_tc"),
              ("D_wide_bf16", "D_wide_chain_bf16", "D_wide_block_bf16"): ("D_wide_chain_bf16",
                                                                          "D_wide_tc_bf16"),
              ("D", "D_chain", "D_block"): ("D_wide_chain", "D_wide_tc"),
              ("D_bf16", "D_chain_bf16", "D_block_bf16"): ("D_wide_chain_bf16", "D_wide_tc_bf16"),
              ("D_resid", "D_chain_resid", "D_block_resid"): ("D_chain_resid", None)}
    for (op, chain, block), (ffma, tc) in routes.items():
        instances = {"chain": registers[ffma]}
        if tc:
            instances["chain_tc"] = registers[tc]
        if key == op:
            return {**instances, "block": registers[op]}
        if key == chain:
            return instances
        if key == block:
            return registers[op]
    if key in ("G", "G_bf16"):  # the xp gate pre-pass, the chain, the per-block route
        sfx = key[1:]
        return {**{p: registers[f"G_{p}{sfx}"] for p in ("gates", "gates_p2", "chain")},
                "block": registers[key]}
    if key.startswith("G_") and key.split("_")[1] in ("gates", "chain"):
        return registers[key]
    # C's and E's builds run their phases' instances (E wide, E resid: the
    # float chain; E wide row8: the bf16 chain with the streams unrounded)
    gru_bwd = {"C": ("C", ""), "C_bf16": ("C", "_bf16"), "E": ("E", ""), "E_wide": ("E", ""),
               "E_resid": ("E", ""), "E_bf16": ("E", "_bf16"), "E_wide_row8_bf16": ("E", "_bf16"),
               "E_wide_bf16": ("E", "_bf16")}
    if key in gru_bwd:
        k, sfx = gru_bwd[key]
        chain = "E_chain_wide_bf16" if key == "E_wide_bf16" else f"{k}_chain{sfx}"
        out = {p: registers[f"{k}_{p}{sfx}"] for p in ("gates", "gates_p2")}
        out["chain"] = registers[chain]
        if k == "C":
            out["dx"] = registers[f"C_dx{sfx}"]
        return out
    if key.startswith(("C_", "E_")) and key.split("_")[1] in ("gates", "chain", "dx"):
        return registers[key]
    phases = {"N": ("gates", "chain", "dx"), "R": ("gates", "chain"), "L": ("xproj", "chain"),
              "A": ("xproj", "chain")}
    base, _, sfx = key.partition("_")
    if base not in phases or sfx not in ("", "bf16"):
        return registers[key]
    return {p: registers[f"{base}_{p}{'_' + sfx if sfx else ''}"] for p in phases[base]}


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    import torch

    from midi_vae_tpu_torch.config import Config, parse_overrides
    from midi_vae_tpu_torch import use_exact_f32

    use_exact_f32()
    registers = phase_build()
    a_c_bits = phase_a_c_bits()
    w_checks = phase_grad_reduce_checks()
    results = phase_kernels()
    paths = {}
    with tempfile.TemporaryDirectory() as work:
        paths["transfer"] = phase_slice(work)
    serving = {"GRU": phase_card_vs_cpu(smi)}
    results.update(phase_train_kernels())
    with tempfile.TemporaryDirectory() as work:
        paths["train"] = phase_train_slice(work)
    step = phase_train_card_vs_cpu(smi, Config(), PER_TRAIN_STEP["narrow"], "train")
    results.update(phase_wide_kernels())
    with tempfile.TemporaryDirectory() as work:
        paths["train_wide"] = phase_train_slice(work, ["lstm_size=512"])
    wide_step = phase_train_card_vs_cpu(smi, Config(lstm_size=512), PER_TRAIN_STEP["wide"],
                                        "wide train")
    tf_step = phase_train_card_vs_cpu(smi, Config(teacher_force=True), PER_TF_STEP,
                                      "teacher-forced train")
    # LSTM serving (kernels L and M) and the judges (A or L)
    results.update(phase_lstm_kernels())
    with tempfile.TemporaryDirectory() as work:
        paths["transfer_lstm_judges"] = phase_slice(work, "LSTM", judges=True)
        paths["transfer_gru_judges"] = phase_slice(work, "GRU", judges=True)
    serving["LSTM"] = phase_card_vs_cpu(smi, "LSTM")
    judges = {c: phase_judges_card_vs_cpu(c) for c in ("LSTM", "GRU")}
    # LSTM training (L, N, S, W; Q and R at 512) and judge training
    results.update(phase_lstm_train_kernels())
    for key, sets in (("train_lstm", ["cell_type=LSTM"]),
                      ("train_lstm_512", ["cell_type=LSTM", "lstm_size=512"])):
        with tempfile.TemporaryDirectory() as work:
            paths[key] = phase_train_slice(work, sets)
    lstm_steps = {H: phase_train_card_vs_cpu(
        smi, Config(cell_type="LSTM", lstm_size=H), PER_TRAIN_STEP[key], f"LSTM({H}) train")
        for H, key in ((256, "lstm_narrow"), (512, "lstm_wide"))}
    with tempfile.TemporaryDirectory() as work:
        judge_paths, judge_steps = phase_judge_training(work, smi)
    paths.update(judge_paths)
    # the per-step cells (T, T xp, S xp) and the configs that run them
    results.update(phase_step_kernels())
    per_step_configs = (
        # Python literals: parse_overrides reads "false" as a (truthy) string
        ("train_merge", "merge", ["merge_decoder_scans=True"]),
        ("train_no_fused_train", "no_fused_train",
         ["fused_train_encoder=False", "fused_train_decoder=False"]),
        ("train_lstm_no_fused_encoder", "lstm_no_fused_encoder",
         ["cell_type=LSTM", "fused_train_encoder=False"]))
    for path, key, sets in per_step_configs:
        with tempfile.TemporaryDirectory() as work:
            paths[path] = phase_train_slice(work, sets, key)
    per_step_steps = {key: phase_train_card_vs_cpu(smi, Config(**parse_overrides(sets)),
                                                   PER_TRAIN_STEP[key], f"{key} train")
                      for _, key, sets in per_step_configs}
    with tempfile.TemporaryDirectory() as work:
        paths["transfer_gru_3layer"], serving["GRU_3layer"] = phase_gru_3layer_serving(work, smi)
    # bf16 training with the whole-scan encoders: X and Y, T's and S's bf16
    # builds, and the configs that run them
    results.update(phase_bf16_kernels())
    bf16_configs = (
        ("train_bf16_no_fused_train", "bf16_no_fused_train",
         ["compute_dtype=bfloat16", "fused_train_encoder=False", "fused_train_decoder=False"]),
        ("train_lstm_bf16_no_fused_encoder", "lstm_bf16_no_fused_encoder",
         ["cell_type=LSTM", "compute_dtype=bfloat16", "fused_train_encoder=False"]))
    for path, key, sets in bf16_configs:
        with tempfile.TemporaryDirectory() as work:
            paths[path] = phase_train_slice(work, sets, key)
    bf16_steps = {key: phase_train_card_vs_cpu(smi, Config(**parse_overrides(sets)),
                                               PER_TRAIN_STEP[key], f"{key} train")
                  for _, key, sets in bf16_configs}
    bf16_steps["lstm_512_bf16_no_fused_encoder"] = phase_train_card_vs_cpu(
        smi, Config(cell_type="LSTM", lstm_size=512, compute_dtype="bfloat16",
                    fused_train_encoder=False),
        PER_TRAIN_STEP["lstm_bf16_no_fused_encoder"], "lstm_512_bf16_no_fused_encoder train")
    # the fused encoder stacks (U and V) through their own entry points: the
    # model keeps the per-layer dispatch, so no main path launches them
    results.update(phase_encoder_stacks())
    # bf16 with the default fused flags: A, C, W, D and E in bf16, the train
    # CLI on Config(compute_dtype="bfloat16"), its step and merge_bf16's card
    # vs CPU
    results.update(phase_bf16_fused_kernels())
    with tempfile.TemporaryDirectory() as work:
        paths["train_bf16"] = phase_train_slice(work, ["compute_dtype=bfloat16"], "bf16")
    for key, overrides in (("bf16", {}), ("merge_bf16", {"merge_decoder_scans": True})):
        bf16_steps[key] = phase_train_card_vs_cpu(
            smi, Config(compute_dtype="bfloat16", **overrides), PER_TRAIN_STEP[key],
            f"{key} train")
    # bf16 on the wide route: X, G, the wide D and E in bf16 and W, the train
    # CLI on wide512_bf16 and its step card vs CPU, and one step on the card
    # of each of the two configs with a fused flag off that the route serves
    results.update(phase_bf16_wide_kernels())
    wide_bf16 = ["lstm_size=512", "compute_dtype=bfloat16"]
    with tempfile.TemporaryDirectory() as work:
        paths["train_wide_bf16"] = phase_train_slice(work, wide_bf16, "wide_bf16")
    bf16_steps["wide_bf16"] = phase_train_card_vs_cpu(
        smi, Config(**parse_overrides(wide_bf16)), PER_TRAIN_STEP["wide_bf16"], "wide_bf16 train")
    for key, flag in (("wide_bf16_no_fused_encoder", "fused_train_encoder=False"),
                      ("wide_bf16_no_fused_decoder", "fused_train_decoder=False")):
        bf16_steps[key] = phase_train_step_card(smi, Config(**parse_overrides([*wide_bf16, flag])),
                                                PER_TRAIN_STEP[key], f"{key} train")
    # the bf16 LSTM with the default fused flags: L, N, Q, R and W in bf16,
    # the train CLI on lstm_bf16, its step and LSTM(512)'s card vs CPU, and
    # one card step of each fused_train_decoder=False variant
    results.update(phase_bf16_lstm_kernels())
    lstm_bf16 = ["cell_type=LSTM", "compute_dtype=bfloat16"]
    with tempfile.TemporaryDirectory() as work:
        paths["train_lstm_bf16"] = phase_train_slice(work, lstm_bf16, "lstm_bf16")
    for key, sets in (("lstm_bf16", lstm_bf16), ("lstm_512_bf16", [*lstm_bf16, "lstm_size=512"])):
        bf16_steps[key] = phase_train_card_vs_cpu(smi, Config(**parse_overrides(sets)),
                                                  PER_TRAIN_STEP[key], f"{key} train")
        bf16_steps[f"{key}_no_fused_decoder"] = phase_train_step_card(
            smi, Config(**parse_overrides([*sets, "fused_train_decoder=False"])),
            PER_TRAIN_STEP[f"{key}_no_fused_decoder"], f"{key}_no_fused_decoder train")
        # LSTM(512) bf16 has no train CLI run: its steps' launches are its path's
        for k in (key, f"{key}_no_fused_decoder"):
            paths[f"step_{k}"] = bf16_steps[k]["launches"]
    # the last kernel instances a config reaches at H <= 512: D's and E's
    # bf16-residual builds (decode_residual_bf16) and rows 7 and 8 in bf16 at
    # H = 512 (E wide's row-8 build); the train CLI on both configs; their
    # steps and the held-notes configs' card vs CPU
    results.update(phase_residual_kernels())
    for path, key, sets in (
            ("train_residual_bf16", "residual_bf16", ["decode_residual_bf16=True"]),
            ("train_bf16_128_512", "bf16_128_512",
             ["lstm_size=512", "compute_dtype=bfloat16", "batch_size=128"])):
        with tempfile.TemporaryDirectory() as work:
            paths[path] = phase_train_slice(work, sets, key)
    residual_steps = {}
    for key, overrides in (
            ("residual_bf16", {"decode_residual_bf16": True}),
            ("held_residual_bf16", {"decode_residual_bf16": True, "meta_held_notes": True}),
            ("held_notes", {"meta_held_notes": True}),
            ("held_bf16", {"meta_held_notes": True, "compute_dtype": "bfloat16"}),
            ("bf16_128_512", {"lstm_size": 512, "compute_dtype": "bfloat16", "batch_size": 128})):
        residual_steps[key] = phase_train_card_vs_cpu(smi, Config(**overrides),
                                                      PER_TRAIN_STEP[key], f"{key} train")
        paths[f"step_{key}"] = residual_steps[key]["launches"]
    print(f"[residual steps] training step ms on the card (CUDA events, median of {STEP_REPS}): "
          f"Config() {step['step_ms']:.3f} (B = {B}); " + ", ".join(
              f"{k} {v['step_ms']:.3f}" for k, v in residual_steps.items())
          + f" (bf16_128_512 at B = 128) on {smi}")
    # GRU(1024): every kernel the JAX package runs at this width (rows 11
    # to 14, f32 and bf16) and the serving kernels against their plain
    # versions; the train and transfer CLIs; a step each, card vs CPU
    results.update(phase_gru1024_kernels())
    paths_1024, steps_1024, serving["GRU_1024"] = phase_gru1024_paths(smi)
    paths.update(paths_1024)
    # generation and the evaluation harness (kernels A and B, L and M),
    # through cli.generate and cli.evaluate, and the harness card vs CPU
    with tempfile.TemporaryDirectory() as work:
        gen_paths, buckets, gen_seconds = phase_generation_slice(work, smi)
    paths.update(gen_paths)
    with tempfile.TemporaryDirectory() as work:
        paths["evaluate"], eval_buckets, eval_seconds = phase_evaluation_slice(work, smi)
    buckets["GRU"] |= eval_buckets
    with tempfile.TemporaryDirectory() as work:
        harness = phase_harness_card_vs_cpu(work, smi, buckets)
    for path, counts in paths.items():
        for name in ("gru_encoder_stack_fwd", "gru_encoder_stack_bwd"):
            if counts.get(name, 0):
                raise RuntimeError(f"the {path} path launched {name} {counts[name]} times")
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")

    # letter, source, replaces, also replaces (midi_vae_tpu/ops/...); "ms",
    # "plain_ms", "bound_ms" and "library_ms" are summed over the kernel's
    # calls in one transfer (A, B, L, M) or one training step (C to G, N to
    # S, W, S xp, T, T xp) of B windows, at GRU(256) for A to E, T and T xp
    # (T: the four head cells of a fused_train_decoder=False step, T xp: its
    # four encoder layers, each cell's loop in one window), GRU(512) for F, G
    # and the wide builds, LSTM(256) for L, M, N, S and S xp, LSTM(512) for Q
    # and R, the bf16 GRU(256) and LSTM(256) steps for X, T bf16, Y and S
    # bf16, the Config() encoder's multi-branch call for U and V (no path
    # runs them; their stack2 calls beside), the bf16 Config() step for A,
    # C, W, D and E in bf16 (W bf16: each layer's and bf16 head's
    # reductions, the float32 one over r * h among them), wide512_bf16's
    # step for G bf16 and the wide D and E in bf16 (X and W bf16 there:
    # "ms_wide_bf16", "ms_wide_bf16_step"), the bf16 LSTM(256) step for L
    # and N in bf16 and LSTM(512)'s for Q and R in bf16 (W bf16 there:
    # "ms_lstm_bf16_step", "ms_lstm_512_bf16_step"); "launches" over the
    # main paths' runs
    meta = {
        "gru_layer_fwd": ("A", "gru_layer_fwd.cu", "fused_train.py:2057", ["fused_train.py:2919"]),
        # rows 1 and 2: A's phases, each a part of _fwdx_kernel and
        # _fwdx_last_kernel: the x @ W pre-pass, the chain; and its per-block
        # route, which no path at H <= 512 takes
        **{f"gru_layer_{op}{sfx}": (f"A {part}{' bf16' if sfx else ''}", "gru_layer_fwd.cu",
                                    "fused_train.py:2057", ["fused_train.py:2919"])
           for op, part in (("xproj", "xproj"), ("fwd_chain", "chain"), ("block", "block"))
           for sfx in ("", "_bf16")},
        "gru_decode": ("B", "gru_decode.cu", "fused_decoder.py:61", ["fused_decoder.py:95"]),
        "gru_layer_bwd": ("C", "gru_layer_bwd.cu", "fused_train.py:2116", []),
        "gru_decode_train": ("D", "gru_decode_train.cu", "fused_train.py:3089",
                             ["fused_train.py:431", "fused_train.py:393"]),
        "gru_decode_bwd": ("E", "gru_decode_bwd.cu", "fused_train.py:3145",
                           ["fused_train.py:602", "fused_train.py:533"]),
        # the weight-grad sums inside _bwdx_kernel, _mh_bwd_kernel, _dec_bwd*_kernel,
        # _bwd_kernel, and the XLA passes _gru_wide_weight_grads, _dec_wide_weight_grads
        "grad_reduce": ("W", "grad_reduce.cu", "fused_train.py:2175",
                        ["fused_train.py:3184", "fused_train.py:567", "fused_train.py:628",
                         "fused_train.py:166", "fused_train.py:2458", "fused_train.py:1436",
                         "fused_train.py:2032"]),
        # rows 11 and 9: _fwd_kernel through _fwd_wide_pallas and _fwd_pallas;
        # its chain (the route at the paths' widths) and per-block route
        "gru_layer_xp_fwd": ("F", "gru_layer_xp_fwd.cu", "fused_train.py:1696",
                             ["fused_train.py:68", "fused_train.py:92"]),
        **{f"gru_layer_xp_fwd_{route}": (f"F {route}", "gru_layer_xp_fwd.cu",
                                         "fused_train.py:1696",
                                         ["fused_train.py:68", "fused_train.py:92"])
           for route in ("chain", "block")},
        # rows 12 and 10: _bwd_wide_kernel and _bwd_kernel
        "gru_layer_xp_bwd": ("G", "gru_layer_xp_bwd.cu", "fused_train.py:1720",
                             ["fused_train.py:1772", "fused_train.py:120", "fused_train.py:177"]),
        # G's phases, each a part of those TPU kernels (in a bf16 model of
        # _bwd_kernel): the xp gate pre-pass, the chain (C's, in G's
        # library); and its per-block route, which no path at H <= 512 takes
        **{f"gru_layer_xp_bwd_{phase}{sfx}": (
            f"G {phase}{' bf16' if sfx else ''}", "gru_layer_xp_bwd.cu",
            "fused_train.py:120" if sfx else "fused_train.py:1720",
            ["fused_train.py:177"] if sfx else ["fused_train.py:1772", "fused_train.py:120",
                                                "fused_train.py:177"])
           for phase in ("gates", "chain", "block") for sfx in ("", "_bf16")},
        # row 13: _dec_fwd1/2_kernel through _dec_fwd_wide_pallas; its chain
        # (the route at the paths' heads) and per-block route, float32 and bf16
        "gru_decode_train_wide": ("D wide", "gru_decode_train.cu", "fused_train.py:1010",
                                  ["fused_train.py:431", "fused_train.py:393"]),
        **{f"gru_decode_train_wide_{route}{sfx}": (
            f"D wide {route}{' bf16' if sfx else ''}", "gru_decode_train.cu",
            "fused_train.py:1010", ["fused_train.py:431", "fused_train.py:393"])
           for route in ("chain", "block") for sfx in ("", "_bf16")},
        # row 14: _dec_bwd2_wide_kernel, _dec_bwd1_wide_kernel
        "gru_decode_bwd_wide": ("E wide", "gru_decode_bwd.cu", "fused_train.py:1080",
                                ["fused_train.py:1135", "fused_train.py:1176"]),
        # rows 21 and 19: _lstm_fwdx_last_kernel, _lstm_fwdx_kernel (with c);
        # its phases, each a part of those TPU kernels: the x @ W pre-pass,
        # the chain; and its per-block route, which no path at H <= 512 takes
        "lstm_layer_fwd": ("L", "lstm_layer_fwd.cu", "fused_train.py:2992",
                           ["fused_train.py:2352"]),
        **{f"lstm_layer_{op}{sfx}": (f"L {part}{' bf16' if sfx else ''}", "lstm_layer_fwd.cu",
                                     "fused_train.py:2352", ["fused_train.py:2992"])
           for op, part in (("xproj", "xproj"), ("fwd_chain", "chain"), ("block", "block"))
           for sfx in ("", "_bf16")},
        # row 34: _decode_kernel_2layer, _decode_kernel_1layer; its decode
        # chain (the route at the paths' widths) and per-block route
        "lstm_decode": ("M", "lstm_decode.cu", "fused_lstm.py:478", ["fused_lstm.py:511"]),
        "lstm_decode_chain": ("M chain", "lstm_decode_chain.cuh", "fused_lstm.py:478",
                              ["fused_lstm.py:511"]),
        "lstm_decode_block": ("M block", "lstm_decode.cu", "fused_lstm.py:478",
                              ["fused_lstm.py:511"]),
        # rows 5 and 7 (f32), 7 in a bf16 model, 5 with bf16 residuals: D's
        # builds on B's decode chain in its training instances (the route
        # at the paths' widths) and on their per-block route (8 rows)
        **{f"gru_decode_train_{route}{sfx}": (
            f"D {route}{' ' + sfx[1:] if sfx else ''}",
            "gru_decode_chain.cuh" if route == "chain" else "gru_decode_train.cu",
            "fused_train.py:393" if sfx == "_bf16" else "fused_train.py:3089",
            ["fused_train.py:431", "fused_train.py:465"] if sfx == "_bf16" else
            ["fused_train.py:3262"] if sfx == "_resid" else
            ["fused_train.py:431", "fused_train.py:393"])
           for route in ("chain", "block") for sfx in ("", "_bf16", "_resid")},
        # row 20: _lstm_bwdx_kernel (its weight-grad sums: W)
        "lstm_layer_bwd": ("N", "lstm_layer_bwd.cu", "fused_train.py:2405", []),
        # rows 15 and 17: _lstm_fwd_kernel through _lstm_fwd_pallas, _lstm_fwd_wide_pallas
        "lstm_layer_xp_fwd": ("Q", "lstm_layer_xp_fwd.cu", "fused_train.py:1331",
                              ["fused_train.py:1352", "fused_train.py:1890"]),
        # rows 16 and 18: _lstm_bwd_kernel, _lstm_bwd_wide_kernel (dU: W)
        "lstm_layer_xp_bwd": ("R", "lstm_layer_xp_bwd.cu", "fused_train.py:1383",
                              ["fused_train.py:1922"]),
        # row 30: _lstm_full_kernel through _lstm_step_pallas
        "lstm_step": ("S", "lstm_step.cu", "fused_lstm.py:67", ["fused_lstm.py:98"]),
        # row 31: _lstm_recurrent_kernel through _lstm_recurrent_pallas
        "lstm_step_xp": ("S xp", "lstm_step.cu", "fused_lstm.py:78", ["fused_lstm.py:126"]),
        # row 28: _gru_full_kernel through _gru_step_pallas
        "gru_step": ("T", "gru_step.cu", "fused_gru.py:54", ["fused_gru.py:95"]),
        # row 29: _gru_recurrent_kernel through _gru_recurrent_pallas
        "gru_step_xp": ("T xp", "gru_step.cu", "fused_gru.py:71", ["fused_gru.py:117"]),
        # rows 26 and 27: _encoder_kernel through _encoder_scan_pallas and,
        # batch-tiled, _encoder_scan_wide_pallas; and row 9 in a bf16 model:
        # _fwd_kernel through _fwd_pallas (gru_layer_xp on bf16 operands)
        "gru_encoder_scan": ("X", "gru_encoder_scan.cu", "fused_decoder.py:288",
                             ["fused_decoder.py:347", "fused_decoder.py:416",
                              "fused_train.py:68", "fused_train.py:92"]),
        # X's per-block route, which no path at H = 256 or 512 takes (X's
        # launches there are its chain's)
        "gru_encoder_scan_block": ("X block", "gru_encoder_scan.cu", "fused_decoder.py:288",
                                   ["fused_decoder.py:347", "fused_decoder.py:416"]),
        # rows 32 and 33: the LSTM's _encoder_kernel through its two wrappers
        "lstm_encoder_scan": ("Y", "lstm_encoder_scan.cu", "fused_lstm.py:228",
                              ["fused_lstm.py:302", "fused_lstm.py:343"]),
        # rows 28 and 30 in a bf16 model
        "gru_step_bf16": ("T bf16", "gru_step.cu", "fused_gru.py:54", ["fused_gru.py:95"]),
        "lstm_step_bf16": ("S bf16", "lstm_step.cu", "fused_lstm.py:67", ["fused_lstm.py:98"]),
        # rows 22 and 24: _stack2_fwd_kernel (through _stack2_fwd_pallas) and
        # _encmb_fwd_kernel (through encode_multibranch_train_fwd)
        "gru_encoder_stack_fwd": ("U", "gru_encoder_stack_fwd.cu", "fused_train.py:2637",
                                  ["fused_train.py:2673", "fused_train.py:3620",
                                   "fused_train.py:3756"]),
        # rows 23 and 25: _stack2_bwd_kernel and _encmb_bwd_kernel (their
        # weight-grad sums: W)
        "gru_encoder_stack_bwd": ("V", "gru_encoder_stack_bwd.cu", "fused_train.py:2702",
                                  ["fused_train.py:2760", "fused_train.py:3667",
                                   "fused_train.py:3810"]),
        # rows 1, 4, 7 and 8 in a bf16 model, and their weight-grad sums:
        # _fwdx_kernel (through _fwdx_pallas), _bwdx_kernel (_bwdx_pallas),
        # _dec_fwd2/1_kernel (_dec_fwd_pallas), _dec_bwd2/1_kernel
        # (_dec_bwd_pallas)
        "gru_layer_fwd_bf16": ("A bf16", "gru_layer_fwd.cu", "fused_train.py:2057",
                               ["fused_train.py:2084"]),
        "gru_layer_bwd_bf16": ("C bf16", "gru_layer_bwd.cu", "fused_train.py:2116",
                               ["fused_train.py:2201"]),
        "gru_decode_train_bf16": ("D bf16", "gru_decode_train.cu", "fused_train.py:393",
                                  ["fused_train.py:431", "fused_train.py:465"]),
        "gru_decode_bwd_bf16": ("E bf16", "gru_decode_bwd.cu", "fused_train.py:533",
                                ["fused_train.py:602", "fused_train.py:650"]),
        "grad_reduce_bf16": ("W bf16", "grad_reduce.cu", "fused_train.py:2175",
                             ["fused_train.py:567", "fused_train.py:628", "fused_train.py:166",
                              "fused_train.py:1262"]),
        # row 10 in a bf16 model: _bwd_kernel through _bwd_pallas (its dU: W)
        "gru_layer_xp_bwd_bf16": ("G bf16", "gru_layer_xp_bwd.cu", "fused_train.py:120",
                                  ["fused_train.py:177"]),
        # rows 13 and 14 in a bf16 model: _dec_fwd2/1_kernel through
        # _dec_fwd_wide_pallas; _dec_bwd2/1_wide_kernel through
        # _dec_bwd_wide_pallas (their weight grads, _dec_wide_weight_grads: W)
        "gru_decode_train_wide_bf16": ("D wide bf16", "gru_decode_train.cu", "fused_train.py:1010",
                                       ["fused_train.py:393", "fused_train.py:431"]),
        "gru_decode_bwd_wide_bf16": ("E wide bf16", "gru_decode_bwd.cu", "fused_train.py:1080",
                                     ["fused_train.py:1135", "fused_train.py:1176"]),
        # rows 19 and 20 in a bf16 model: _lstm_fwdx_kernel (through
        # _lstm_fwdx_pallas), _lstm_bwdx_kernel (_lstm_bwdx_pallas; its
        # weight-grad sums: W bf16)
        "lstm_layer_fwd_bf16": ("L bf16", "lstm_layer_fwd.cu", "fused_train.py:2352",
                                ["fused_train.py:2374"]),
        "lstm_layer_bwd_bf16": ("N bf16", "lstm_layer_bwd.cu", "fused_train.py:2405",
                                ["fused_train.py:2472"]),
        # rows 17 and 15 in a bf16 model: _lstm_fwd_kernel through
        # _lstm_fwd_wide_pallas and _lstm_fwd_pallas; rows 18 and 16:
        # _lstm_bwd_wide_kernel and _lstm_bwd_kernel (dU: W bf16)
        "lstm_layer_xp_fwd_bf16": ("Q bf16", "lstm_layer_xp_fwd.cu", "fused_train.py:1331",
                                   ["fused_train.py:1890", "fused_train.py:1352"]),
        "lstm_layer_xp_bwd_bf16": ("R bf16", "lstm_layer_xp_bwd.cu", "fused_train.py:1922",
                                   ["fused_train.py:1984", "fused_train.py:1383",
                                    "fused_train.py:1448"]),
        # the phases of N and R (csrc/lstm_cell_bwd.cuh), each a part of the
        # TPU kernels above: the gate recompute, the serial chain, N's dx
        **{f"{op}_{phase}{sfx}": (f"{letter} {phase}{' bf16' if sfx else ''}", source, *rows)
           for op, letter, source, rows in (
               ("lstm_layer_bwd", "N", "lstm_layer_bwd.cu",
                ("fused_train.py:2405", ["fused_train.py:2472"])),
               ("lstm_layer_xp_bwd", "R", "lstm_layer_xp_bwd.cu",
                ("fused_train.py:1383", ["fused_train.py:1922", "fused_train.py:1448",
                                         "fused_train.py:1984"])))
           for phase in (("gates", "chain", "dx") if letter == "N" else ("gates", "chain"))
           for sfx in ("", "_bf16")},
        # rows 5 and 6 with bf16 residuals (decode_residual_bf16):
        # _mh_fwd_kernel (through multihead_decode_train_fwd) storing the h
        # sequences in bf16, _mh_bwd_kernel (multihead_decode_train_bwd)
        # reading them (its weight-grad sums: W)
        "gru_decode_train_resid": ("D resid", "gru_decode_train.cu", "fused_train.py:3089",
                                   ["fused_train.py:3262"]),
        "gru_decode_bwd_resid": ("E resid", "gru_decode_bwd.cu", "fused_train.py:3145",
                                 ["fused_train.py:3331"]),
        # row 8 in a bf16 model where its 8-row build does not launch (H =
        # 512): _dec_bwd1/2_kernel through _dec_bwd_pallas (its weight-grad
        # sums: W bf16); row 7's forward is D wide bf16's ("ms_rows78")
        "gru_decode_bwd_wide_row8_bf16": ("E wide row8 bf16", "gru_decode_bwd.cu",
                                          "fused_train.py:602",
                                          ["fused_train.py:533", "fused_train.py:650"]),
        # the phases of C and E (csrc/gru_cell_bwd_chain.cuh), each a part of
        # the TPU kernels above: the gate recompute, the serial chain, C's dx
        **{f"gru_layer_bwd_{phase}{sfx}": (f"C {phase}{' bf16' if sfx else ''}",
                                           "gru_layer_bwd.cu", "fused_train.py:2116",
                                           ["fused_train.py:2201"])
           for phase in ("gates", "chain", "dx") for sfx in ("", "_bf16")},
        **{f"gru_decode_bwd_{phase}{sfx}": (f"E {phase}{' bf16' if sfx else ''}",
                                            "gru_decode_bwd.cu", "fused_train.py:3145",
                                            ["fused_train.py:533", "fused_train.py:602",
                                             "fused_train.py:1080", "fused_train.py:1135"])
           for phase in ("gates", "chain") for sfx in ("", "_bf16")},
    }
    # per kernel: the calls of one step or transfer at other shapes
    extra = {"gru_layer_fwd": [("ms_h512", "gru_layer_512")],
             "gru_decode": [("ms_h512", "gru_decode_512")],
             "grad_reduce": [("ms_wide_step", "grad_reduce_wide"),
                             ("ms_lstm_step", "grad_reduce_lstm"),
                             ("ms_lstm_512_step", "grad_reduce_lstm_wide")],
             "gru_layer_xp_fwd": [("ms_h256", "xp_h256_fwd")],
             "gru_layer_xp_fwd_chain": [("ms_h256", "xp_h256_fwd_chain")],
             "gru_layer_xp_fwd_block": [("ms_h256", "xp_h256_fwd_block")],
             "gru_layer_xp_bwd": [("ms_h256", "xp_h256_bwd")],
             "lstm_layer_fwd": [("ms_train_step", "lstm_layer_train_fwd")],
             "lstm_layer_xproj": [("ms_train_step", "lstm_layer_xproj_train")],
             "lstm_layer_fwd_chain": [("ms_train_step", "lstm_layer_fwd_chain_train")],
             "lstm_step_xp": [("ms_h512", "lstm_step_xp_512")],
             "gru_step": [("ms_h512", "gru_step_512")],
             "gru_step_xp": [("ms_h512", "gru_step_xp_512")],
             "gru_encoder_scan": [("ms_row27", "gru_encoder_scan_row27"),
                                  ("ms_wide_bf16", "gru_encoder_scan_wide_bf16")],
             "grad_reduce_bf16": [("ms_wide_bf16_step", "grad_reduce_wide_bf16"),
                                  ("ms_lstm_bf16_step", "grad_reduce_lstm_bf16"),
                                  ("ms_lstm_512_bf16_step", "grad_reduce_lstm_512_bf16"),
                                  ("ms_resid", "grad_reduce_resid"),
                                  ("ms_rows78", "grad_reduce_rows78_bf16")],
             "gru_decode_train_wide_bf16": [("ms_rows78", "gru_decode_train_rows78")],
             "gru_decode_train_wide_chain_bf16": [("ms_rows78", "gru_decode_train_rows78")],
             # E's phases on the wide route, with bf16 residuals, in rows 13
             # and 14 and in rows 7 and 8 at H = 512
             **{f"gru_decode_bwd_{p}": [("ms_wide_step", f"gru_decode_bwd_{p}_wide"),
                                        ("ms_resid", f"gru_decode_bwd_{p}_resid")]
                for p in ("gates", "chain")},
             **{f"gru_decode_bwd_{p}_bf16": [("ms_wide_bf16", f"gru_decode_bwd_{p}_wide_bf16"),
                                             ("ms_rows78", f"gru_decode_bwd_{p}_rows78_bf16")]
                for p in ("gates", "chain")},
             "lstm_encoder_scan": [("ms_h512", "lstm_encoder_scan_512")],
             "gru_encoder_stack_fwd": [("ms_stack2", "stack2_fwd"),
                                       ("ms_stack2_bf16", "stack2_bf16_fwd"),
                                       ("ms_h512", "stack2_512_fwd")],
             "gru_encoder_stack_bwd": [("ms_stack2", "stack2_bwd"),
                                       ("ms_stack2_bf16", "stack2_bf16_bwd"),
                                       ("ms_h512", "stack2_512_bwd")]}
    # GRU(1024) (phase_gru1024_kernels), B = 256: F, G (and its phases), W,
    # the wide D and E (and E's phases), A and B over the four layers and
    # three heads; X, G, W, the wide D and E in bf16 (the instrument head)
    for name, res in (("gru_layer_fwd", "gru1024_layer"), ("gru_decode", "gru1024_decode"),
                      ("gru_layer_xp_fwd", "gru1024_xp_fwd"),
                      ("gru_layer_xp_fwd_chain", "gru1024_xp_fwd"),
                      ("gru_layer_xp_bwd", "gru1024_xp_bwd"),
                      ("grad_reduce", "gru1024_grad_reduce"),
                      ("gru_decode_train_wide", "gru1024_decode_train_wide"),
                      ("gru_decode_train_wide_chain", "gru1024_decode_train_wide"),
                      ("gru_decode_bwd_wide", "gru1024_decode_bwd_wide"),
                      ("gru_encoder_scan", "gru1024_encoder_scan"),
                      ("gru_layer_xp_bwd_bf16", "gru1024_xp_bwd_bf16"),
                      ("grad_reduce_bf16", "gru1024_grad_reduce_bf16"),
                      ("gru_decode_train_wide_bf16", "gru1024_decode_train_wide_bf16"),
                      ("gru_decode_train_wide_chain_bf16", "gru1024_decode_train_wide_bf16"),
                      ("gru_decode_bwd_wide_bf16", "gru1024_decode_bwd_wide_bf16"),
                      *((f"gru_layer_xp_bwd_{p}{s_}", f"gru1024_layer_xp_bwd_{p}{s_}")
                        for p in ("gates", "chain") for s_ in ("", "_bf16")),
                      *((f"gru_decode_bwd_{p}", f"gru1024_decode_bwd_{p}_wide")
                        for p in ("gates", "chain")),
                      *((f"gru_decode_bwd_{p}_bf16", f"gru1024_decode_bwd_{p}_bf16")
                        for p in ("gates", "chain"))):
        extra.setdefault(name, []).append(("ms_h1024", res))
    kernels = []
    for name, (letter, source, replaces, also) in meta.items():
        per_call = results[name]
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
        bound_ms, bound_by = calls_bound(per_call.values())
        library = [r["library_ms"] for r in per_call.values()]
        entry = {
            "name": name, "letter": letter, "route": "cuda",
            "source": f"midi_vae_tpu_torch/csrc/{source}",
            "replaces": f"midi_vae_tpu/ops/{replaces}",
            "also_replaces": [f"midi_vae_tpu/ops/{a}" for a in also],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in per_call.values()),
            "ms": sum(r["ms"] for r in per_call.values()),
            "plain_ms": sum(r["plain_ms"] for r in per_call.values()),
            "bound_ms": bound_ms, "bound_by": bound_by,
            # one PyTorch call of the same function: cuBLAS's a.t() @ b for W,
            # cuDNN's LSTM for L, N, Q, R (in bf16 their bf16 builds; Q and
            # R with w_ih = I) and (bf16, w_ih = I) Y,
            # torch.lstm_cell for S, S bf16 and S xp (with w_ih = I: one
            # product more); none for the GRU kernels (nn.GRU, torch.gru_cell
            # are reset-after) and the decode kernels (no call feeds back
            # outputs)
            "library_ms": sum(library) if None not in library else None,
            "calls": per_call,
            "registers": kernel_registers(registers, letter),
        }
        for key, res in extra.get(name, []):
            calls = results[res]
            if not calls:  # a width whose build does not launch (phase 29, H = 512)
                continue
            entry[key] = sum(r["ms"] for r in calls.values())
            entry["plain_" + key] = sum(r["plain_ms"] for r in calls.values())
            entry["max_abs_err"] = max(entry["max_abs_err"], *(r["max_abs_err"] for r in calls.values()))
            entry["calls_" + key.removeprefix("ms_")] = calls
        kernels.append(entry)
    # D's and M's route counters on the paths that run them: every launch
    # their chains' (the launch tables hold each path to it)
    routes = {f"{k}{sfx}": v for k, v in (("gru_decode_train_chain", 0),
                                           ("gru_decode_train_block", 0)) for sfx in
              ("", "_bf16", "_resid")} | {"lstm_decode_chain": 0, "lstm_decode_block": 0}
    for path in ("train", "train_bf16", "train_residual_bf16", "transfer_lstm_judges"):
        got = {k: paths[path].get(k, 0) for k in routes}
        if not any(got.values()) or any(v for k, v in got.items() if "block" in k):
            raise RuntimeError(f"the {path} path launched D or M off their chains: {got}")
        print(f"[routes] {path}: " + ", ".join(f"{k} {v}" for k, v in got.items() if v))
    wall_s = time.perf_counter() - t_start
    print(f"[done] every phase passed in {wall_s:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels, "train_step": step, "train_step_512": wide_step,
                      "train_step_teacher_force": tf_step, "serving": serving,
                      "judges_card_vs_cpu": judges, "train_step_lstm": lstm_steps[256],
                      "train_step_lstm_512": lstm_steps[512], "judge_train_step": judge_steps,
                      "train_step_per_step_cells": per_step_steps,
                      "train_step_bf16": bf16_steps, "train_step_residual": residual_steps,
                      "train_step_1024": steps_1024,
                      "lstm_fwd_bwd_vs_cudnn": results["lstm_fwd_bwd_vs_cudnn"],
                      "encoder_stack_vs_per_layer": results["encoder_route"],
                      "generate_seconds": gen_seconds, "evaluate_seconds": eval_seconds,
                      "harness_card_vs_cpu": harness,
                      "grad_reduce_checks": w_checks, "a_c_digests": a_c_bits, "power": smi,
                      "wall_s": wall_s, "phase_seconds": PHASE_SECONDS}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# seconds each phase took, in order: printed as it ends (so that a run cut
# at its time limit still shows where its time went) and in the result line
PHASE_SECONDS: list[tuple[str, float]] = []


def _timed(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            PHASE_SECONDS.append((fn.__name__, time.perf_counter() - t0))
            print(f"[time] {fn.__name__} {PHASE_SECONDS[-1][1]:.1f} s", flush=True)
    return run


for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = _timed(globals()[_name])


if __name__ == "__main__":
    sys.exit(main())

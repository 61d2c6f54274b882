"""CPU parity of the port's training step against the JAX package.

The JAX side runs its full Pallas kernel tier in interpret mode
(``MidiVAE._interpret = True``); the port runs the same dispatch glue with
the kernels' plain versions (CPU tensors). Same parameters, same numpy batch
(with padding rows masked by ``M``), and the reparameterization noise
computed on the JAX side exactly as ``sample_z`` draws it and handed to the
port. Tolerances:
- the loss and every metric: atol 1e-5 (float32);
- every parameter gradient: atol 1e-5 + rtol 1e-4, for f32 sums taken in
  another order;
- 5-step optimizer trajectories: atol 1e-6 + rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu.models.vae import loss_and_metrics as jax_loss
from midi_vae_tpu.training.keras_optim import keras_adam, keras_rmsprop
from midi_vae_tpu_torch import bridge
from midi_vae_tpu_torch.models.vae import MidiVAE, loss_and_metrics
from midi_vae_tpu_torch.training.keras_optim import OPTIMIZERS

LOSS_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
CONFIGS = {
    "default": {},
    "held_and_next": {"meta_held_notes": True, "meta_next_notes": True},
    "no_history": {"history": False},
    "silent_weight_epsilon_factor": {"silent_weight": 0.5, "epsilon_factor": 0.1},
    # the notes head's plain teacher-forced scan beside the decode kernels'
    # plain versions for the velocity and instrument heads
    "teacher_force": {"teacher_force": True},
}
B, VALID = 5, 3  # batch rows, of which the last two are padding


def make_batch(cfg, seed=0):
    """A numpy training batch with rows VALID.. zeroed and masked out, as
    pad_batch_to leaves a short batch."""
    rng = np.random.RandomState(seed)
    eye = lambda d, idx: np.eye(d, dtype=np.float32)[idx]  # noqa: E731
    Y = eye(cfg.output_dim, rng.randint(0, cfg.output_dim, (B, cfg.output_length)))
    Y[:, ::3] = eye(cfg.output_dim, np.full((B, len(range(0, cfg.output_length, 3))),
                                            cfg.output_dim - 1))  # silent steps
    batch = {
        "X": eye(cfg.input_dim, rng.randint(0, cfg.input_dim, (B, cfg.input_length))),
        "Y": Y,
        "I": eye(cfg.instrument_dim, rng.randint(0, cfg.instrument_dim, (B, cfg.max_voices))),
        "V": rng.rand(B, cfg.output_length, 1).astype(np.float32),
        "D": eye(2, rng.randint(0, 2, (B, cfg.output_length))),
        "C": eye(cfg.num_classes, rng.randint(0, cfg.num_classes, B)),
        "S": rng.randn(B, cfg.signature_vector_length).astype(np.float32),
    }
    if cfg.history:
        batch["H"] = (0.5 * rng.randn(B, cfg.latent_dim)).astype(np.float32)
    if cfg.meta_next_notes:
        batch["N"] = eye(cfg.output_dim, rng.randint(0, cfg.output_dim, (B, cfg.output_length)))
    for v in batch.values():
        v[VALID:] = 0
    batch["M"] = (np.arange(B) < VALID).astype(np.float32)
    return batch


def jax_noise(cfg, key):
    """The noise sample_z draws inside the JAX loss: eps * N(0, 1)."""
    return np.asarray(cfg.epsilon_std * jax.random.normal(key, (B, cfg.latent_dim), jnp.float32))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def loss_pair(request):
    """(name, cfg, numpy params, batch, noise, jax loss, jax metrics, flat jax grads)."""
    cfg = small_test_config(**CONFIGS[request.param])
    jm = JaxVAE(cfg)
    jm._interpret = True
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(3)))
    batch = make_batch(cfg)
    key = jax.random.PRNGKey(1)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss(jm, p, b, key, cfg.epsilon_std), has_aux=True))
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    flat_grads = bridge.flatten(jax.tree_util.tree_map(np.asarray, grads))
    return (request.param, cfg, params, batch, jax_noise(cfg, key), float(loss),
            {k: float(v) for k, v in metrics.items()}, flat_grads)


def port_loss(cfg, params, batch, noise):
    model = MidiVAE(cfg, params, trainable=True)
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    loss, metrics = loss_and_metrics(model, tb, noise=torch.from_numpy(noise.copy()))
    named = list(model.params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return loss, metrics, {k.replace(".", "/"): g for (k, _), g in zip(named, grads)}


def test_loss_and_metrics_match_jax(loss_pair):
    name, cfg, params, batch, noise, want_loss, want_metrics, _ = loss_pair
    loss, metrics, _ = port_loss(cfg, params, batch, noise)
    assert sorted(metrics) == sorted(want_metrics), name
    np.testing.assert_allclose(loss.item(), want_loss, rtol=0, atol=LOSS_ATOL)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=0, atol=LOSS_ATOL, err_msg=k)


def test_every_parameter_gradient_matches_jax(loss_pair):
    name, cfg, params, batch, noise, _, _, want = loss_pair
    _, _, got = port_loss(cfg, params, batch, noise)
    assert sorted(got) == sorted(want), name
    for k, w in want.items():
        g = np.zeros_like(w) if got[k] is None else got[k].numpy()
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"{name}: {k}")


def test_padding_rows_do_not_move_the_loss():
    """Rows with M = 0 contribute nothing: changing them leaves loss and
    grads bit-equal."""
    cfg = small_test_config()
    params = MidiVAE(cfg).init_params(np.array([0, 4], np.uint32))
    batch = make_batch(cfg, seed=1)
    noise = np.zeros((B, cfg.latent_dim), np.float32)
    other = {k: v.copy() for k, v in batch.items()}
    other["X"][VALID:] = np.eye(cfg.input_dim, dtype=np.float32)[0]
    other["V"][VALID:] = 0.7
    a, b = port_loss(cfg, params, batch, noise), port_loss(cfg, params, other, noise)
    assert a[0].item() == b[0].item()
    for k in a[2]:
        if a[2][k] is not None:
            assert torch.equal(a[2][k], b[2][k]), k


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_trajectories_match_jax(name):
    rng = np.random.RandomState(7)
    tree = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in tree.items()} for _ in range(5)]
    lr = 1e-2
    tx = {"adam": optax.adam(lr), "rmsprop": optax.rmsprop(lr), "adam_keras": keras_adam(lr),
          "rmsprop_keras": keras_rmsprop(lr)}[name]
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    port_params = [torch.from_numpy(tree[k].copy()) for k in sorted(tree)]
    opt = OPTIMIZERS[name](port_params, sorted(tree), lr)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
        opt.step([torch.from_numpy(g[k]) for k in sorted(tree)])
        for k, p in zip(sorted(tree), port_params):
            np.testing.assert_allclose(p.numpy(), np.asarray(params[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} step {opt.count} {k}")
    # the state round-trips through its checkpoint form
    again = OPTIMIZERS[name]([p.clone() for p in port_params], sorted(tree), lr)
    again.load_state_dict(opt.state_dict())
    assert again.count == opt.count == 5
    for slot, tensors in opt.state.items():
        assert all(torch.equal(a, b) for a, b in zip(tensors, again.state[slot])), slot


@pytest.mark.parametrize("overrides, row", [
    # teacher forcing runs no per-step kernel in the JAX package: the forced
    # head takes the plain scan, the others the decode kernels
    ({"teacher_force": True}, True),
    ({"meta_next_notes": True, "meta_next_notes_teacher_force": True}, True),
    # the per-step cells (rows 28, 29, 31) are ported: (steps, layers) of
    # train_kernels, each part deciding on its own
    ({"merge_decoder_scans": True}, (True, True)),
    ({"fused_train_encoder": False}, (True, True)),
    ({"fused_train_decoder": False}, (True, True)),
    # bf16 with the default flags runs A, C, D, E and W in bf16; with
    # both fused_train_* False the whole-scan kernel X and T's bf16 build
    ({"compute_dtype": "bfloat16"}, (True, True)),
    ({"compute_dtype": "bfloat16", "fused_train_encoder": False,
      "fused_train_decoder": False}, (True, True)),
    # LSTM trains on the card since its kernels (rows 15-20, 30 and 31) are
    # ported, in bf16 too (L, N, Q and R have bf16 builds, S has its own)
    ({"cell_type": "LSTM"}, True),
    ({"cell_type": "LSTM", "fused_train_encoder": False}, (True, True)),
    ({"cell_type": "LSTM", "compute_dtype": "bfloat16"}, (True, True)),
    # cells other than tanh train through the plain scans, as in the JAX
    # package (fused_train.py:2269, :1668, :3456, :981)
    ({"lstm_activation": "sigmoid"}, False),
    # ... but the per-step cells take them: with fused_train_decoder=False
    # the JAX package runs its heads through _gru_full_kernel whatever the
    # cell activation, while the encoder keeps the plain scan
    ({"lstm_activation": "sigmoid", "fused_train_decoder": False}, (True, False)),
    # ... and in bf16 too: with the default flags the JAX package runs no
    # kernel for sigmoid cells (plain encoder scans and heads)
    ({"lstm_activation": "sigmoid", "compute_dtype": "bfloat16"}, False),
], ids=["teacher_force", "next_teacher_force", "merge_decoder_scans", "no_fused_encoder",
        "no_fused_decoder", "bfloat16", "bfloat16_no_fused_train", "lstm",
        "lstm_no_fused_encoder", "lstm_bfloat16", "sigmoid_cells", "sigmoid_no_fused_decoder",
        "sigmoid_bfloat16"])
def test_unported_training_configs_raise_on_cuda(overrides, row):
    """The gate needs no card: it decides from the device type. On CUDA each
    unported config raises naming its row or ROADMAP item, and on the CPU it
    takes the plain path; a ported one (``row`` True or False, or its
    (steps, layers) of ``train_kernels`` with kernels on) answers the same on
    both."""
    model = MidiVAE(small_test_config(**overrides))
    if isinstance(row, tuple):
        for device in ("cuda", "cpu"):
            assert model.train_kernels(torch.device(device)) == row
            assert model.train_kernels_enabled(torch.device(device)) is True
        return
    if isinstance(row, bool):
        assert model.train_kernels_enabled(torch.device("cuda")) is row
        assert model.train_kernels_enabled(torch.device("cpu")) is row
        return
    with pytest.raises(NotImplementedError, match=row):
        model.train_kernels_enabled(torch.device("cuda"))
    assert model.train_kernels_enabled(torch.device("cpu")) is False


def test_default_config_selects_the_training_kernels():
    model = MidiVAE(small_test_config())
    assert model.train_kernels_enabled(torch.device("cuda")) is True
    assert model.train_kernels_enabled(torch.device("cpu")) is True
    for overrides in ({"use_pallas": "off"}, {"gate_activation": "hard_sigmoid"},
                      {"cell_type": "SimpleRNN"}):
        # the JAX package runs these as plain scans on every platform
        assert MidiVAE(small_test_config(**overrides)).train_kernels_enabled(
            torch.device("cuda")) is False


def test_bridge_trainable_mode():
    cfg = small_test_config()
    tree = MidiVAE(cfg).init_params(np.array([0, 1], np.uint32))
    served = MidiVAE(cfg, tree)
    trained = MidiVAE(cfg, tree, trainable=True)
    assert not any(p.requires_grad for p in served.params.parameters())
    assert all(p.requires_grad for p in trained.params.parameters())
    assert all(p.is_contiguous() for p in trained.params.parameters())
    assert not any(p.requires_grad for p in bridge.to_module(tree).parameters())
    flat, back = bridge.flatten(tree), bridge.flatten(bridge.to_tree(trained.params))
    assert all(np.array_equal(flat[k], back[k]) for k in flat)


def test_bfloat16_trains_on_the_cpu_in_bfloat16():
    """compute_dtype='bfloat16' with the default flags runs the kernels'
    plain bf16 versions on the CPU, as the JAX package casts params and batch, with f32
    losses and f32 parameter grads; the loss lands within bf16's precision
    (atol 2e-2) of the f32 loss."""
    losses = {}
    for dtype in ("float32", "bfloat16"):
        cfg = small_test_config(compute_dtype=dtype)
        model = MidiVAE(cfg, MidiVAE(cfg).init_params(np.array([0, 3], np.uint32)), trainable=True)
        batch = {k: torch.from_numpy(v.copy()) for k, v in make_batch(cfg).items()}
        noise = torch.zeros(B, cfg.latent_dim)
        assert model.apply(batch, noise=noise)["z"].dtype == getattr(torch, dtype)
        loss, _ = loss_and_metrics(model, batch, noise=noise)
        grads = torch.autograd.grad(loss, list(model.params.parameters()), allow_unused=True)
        assert loss.dtype == torch.float32
        assert all(g.dtype == torch.float32 for g in grads if g is not None)
        losses[dtype] = loss.item()
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=0, atol=2e-2)

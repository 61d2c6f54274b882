"""CPU tests of the port's epochs against the JAX package's ``fit``: the
history latents from the train steps' z cache (``history_from_train_z``, the
default) and the batch order of ``_epoch_orders``.

Both trainers start from the same parameters; ``epsilon_std=0`` leaves no
noise to draw, so the runs see the same batches, the same history latents
and the same deterministic latent. The JAX trainer runs its one-process
default, ``_fit_device``, through its plain jnp path (no Pallas kernel on
the CPU). Per-epoch train metrics: atol 1e-5 (float32 means). Parameters
after 2 epochs of 3 Adam steps: atol 1e-5 + rtol 1e-4, as the three-step
test of ``test_torch_train_loop.py`` (f32 gradients summed in another order;
Adam divides each update by the gradient's own magnitude).
"""

import jax
import numpy as np
import pytest
import torch

from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.parallel import make_mesh
from midi_vae_tpu.training.trainer import TrainState as JaxState
from midi_vae_tpu.training.trainer import VAETrainer as JaxTrainer
from midi_vae_tpu_torch import bridge
from midi_vae_tpu_torch.training import trainer as port_trainer
from midi_vae_tpu_torch.training.trainer import VAETrainer, epoch_order
from test_torch_train_loop import make_flat

RTOL, ATOL = 1e-4, 1e-5
METRIC_ATOL = 1e-5


def _cfg(**overrides):
    # 10 windows in 3 songs, batch 4: 3 steps an epoch, the last one padded
    return small_test_config(batch_size=4, epsilon_std=0.0, save_step=1, **overrides)


def _jax_fit(cfg, flat, epochs_each, interpret=False):
    """The JAX fit over ``epochs_each`` = [(first, stop), ...]: each entry
    one fit call; a later call starts from a state with no z cache, as a
    restore gives it; ``interpret`` runs its kernel tier in interpret mode.
    Returns (train metrics per epoch, numpy params)."""
    jt = JaxTrainer(cfg, mesh=make_mesh(devices=[jax.devices()[0]]))
    jt.model._interpret = interpret
    state = jt.init_state()
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    metrics = []
    for first, stop in epochs_each:
        if first:
            state = JaxState(params=state.params, opt_state=state.opt_state, rng=state.rng,
                             epoch=first)
        metrics += jt.fit(state, flat, None, epochs=stop, log_fn=lambda m: None,
                          plot=False)["train"]
    return params0, metrics, jax.tree_util.tree_map(np.asarray, state.params)


def _assert_run_matches(port_metrics, port_state, jax_metrics, jax_params):
    assert len(port_metrics) == len(jax_metrics)
    for e, (got, want) in enumerate(zip(port_metrics, jax_metrics)):
        assert sorted(got) == sorted(want), e
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=METRIC_ATOL,
                                       err_msg=f"epoch {e} {k}")
    want = bridge.flatten(jax_params)
    got = bridge.flatten(bridge.to_tree(port_state.model.params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_epoch_order_is_the_jax_packages():
    cfg = _cfg()
    jt = JaxTrainer(cfg, mesh=make_mesh(devices=[jax.devices()[0]]))
    for shuffle in (True, False):
        orders, masks, _ = jt._epoch_orders(10, 3, shuffle, 2, True)
        for i in range(3):
            grid, mask = epoch_order(cfg, 10, 2 + i, shuffle)
            np.testing.assert_array_equal(grid, orders[i])
            np.testing.assert_array_equal(mask, masks[i])


def test_two_epochs_match_the_jax_fit():
    """Two shuffled epochs with history: epoch 1 reads the z cache that
    epoch 0's steps wrote, rolled within songs."""
    cfg = _cfg()
    flat = make_flat(cfg)
    params0, jax_metrics, jax_params = _jax_fit(cfg, flat, [(0, 2)])
    trainer = VAETrainer(cfg, "cpu")
    state = trainer.new_state(params0)
    hist = trainer.fit(state, flat, None, epochs=2, log_fn=lambda m: None, plot=False)
    _assert_run_matches(hist["train"], state, jax_metrics, jax_params)
    # the cache holds the z_mean each window had at its last step; the
    # dustbin row took the padding rows
    assert state.z_cache.shape == (flat.num_windows + 1, cfg.latent_dim)
    assert torch.count_nonzero(state.z_cache[: flat.num_windows].abs().sum(-1)) == flat.num_windows


def test_two_epochs_match_the_jax_fit_bf16():
    """The bf16 slice config (compute_dtype="bfloat16", both fused_train_*
    False: the whole-scan kernel X and T's bf16 build) through two epochs,
    against the JAX fit with its kernels in interpret mode. bf16 tolerances,
    from what this run measures: the per-epoch losses within 5e-4 (measured
    2.3e-4), the accuracies within 2.5e-2 (two argmax flips among the 80
    note steps of an epoch: near-ties flip in bf16; measured one), the z
    cache filled in float32 as the JAX package's; each parameter's update
    over the 6 Adam steps within 0.2 of its L2 norm (measured 8.5e-2: Adam
    divides each update by the gradient's own magnitude, so parameters with
    near-zero gradients carry the bf16 gradients' 1.5e-2 relative gap
    further)."""
    cfg = _cfg(compute_dtype="bfloat16", fused_train_encoder=False, fused_train_decoder=False)
    flat = make_flat(cfg)
    params0, jax_metrics, jax_params = _jax_fit(cfg, flat, [(0, 2)], interpret=True)
    trainer = VAETrainer(cfg, "cpu")
    state = trainer.new_state(params0)
    hist = trainer.fit(state, flat, None, epochs=2, log_fn=lambda m: None, plot=False)
    assert state.z_cache.dtype == torch.float32
    assert torch.count_nonzero(state.z_cache[: flat.num_windows].abs().sum(-1)) == flat.num_windows
    assert len(hist["train"]) == len(jax_metrics) == 2
    for e, (got, want) in enumerate(zip(hist["train"], jax_metrics)):
        assert sorted(got) == sorted(want), e
        for k, v in want.items():
            atol = 2.5e-2 if k.endswith("_acc") else 5e-4
            np.testing.assert_allclose(got[k], v, rtol=0, atol=atol, err_msg=f"epoch {e} {k}")
    want, start = bridge.flatten(jax_params), bridge.flatten(params0)
    got = bridge.flatten(bridge.to_tree(state.model.params))
    assert sorted(got) == sorted(want)
    for k in want:
        step = want[k] - start[k]
        err = np.linalg.norm((got[k] - start[k]) - step) / max(np.linalg.norm(step), 1e-12)
        assert err <= 0.2, f"{k}: update relative L2 error {err:.3e}"


def test_resumed_run_seeds_the_cache_and_matches_the_jax_fit(tmp_path, monkeypatch):
    """One epoch, restore, one more: the resumed epoch's history comes from
    one encode pass with the restored parameters (the seeded cache), not from
    the cache of the epoch before, as in the JAX package; the result differs
    from two straight epochs."""
    cfg = _cfg()
    flat = make_flat(cfg)
    params0, jax_metrics, jax_params = _jax_fit(cfg, flat, [(0, 1), (1, 2)])
    trainer = VAETrainer(cfg, "cpu")
    run = str(tmp_path / "run")
    first = trainer.fit(trainer.new_state(params0), flat, None, epochs=1, output_dir=run,
                        log_fn=lambda m: None, plot=False)
    resumed = trainer.restore(run)
    assert resumed.z_cache is None and resumed.epoch == 1
    encodes = []
    real_encode = trainer.encode_all
    monkeypatch.setattr(trainer, "encode_all", lambda m, f: encodes.append(1) or real_encode(m, f))
    seeded = trainer.z_cache_for(resumed, flat)
    np.testing.assert_array_equal(seeded[: flat.num_windows].numpy(),
                                  real_encode(resumed.model, flat))
    second = trainer.fit(resumed, flat, None, epochs=2, output_dir=run, log_fn=lambda m: None,
                         plot=False)
    assert len(encodes) == 2  # the check above, and the seeding pass of fit
    _assert_run_matches(first["train"] + second["train"][1:], resumed, jax_metrics, jax_params)
    straight = trainer.new_state(params0)
    trainer.fit(straight, flat, None, epochs=2, log_fn=lambda m: None, plot=False)
    assert not all(torch.equal(a, b) for a, b in zip(straight.model.params.parameters(),
                                                     resumed.model.params.parameters()))


@pytest.mark.parametrize("from_train_z", [True, False])
def test_history_source_per_epoch(from_train_z, monkeypatch):
    """``history_from_train_z=False`` keeps an encode pass at the start of
    every epoch after the first; the default encodes nothing (the train
    steps fill the cache) and matches the JAX fit of the same flag."""
    cfg = _cfg(history_from_train_z=from_train_z)
    flat = make_flat(cfg)
    trainer = VAETrainer(cfg, "cpu")
    passes = []
    real = port_trainer.VAETrainer.encode_all
    monkeypatch.setattr(port_trainer.VAETrainer, "encode_all",
                        lambda self, m, f: passes.append(1) or real(self, m, f))
    params0, jax_metrics, jax_params = _jax_fit(cfg, flat, [(0, 3)])
    state = trainer.new_state(params0)
    hist = trainer.fit(state, flat, None, epochs=3, log_fn=lambda m: None, plot=False)
    assert len(passes) == (0 if from_train_z else 2)
    assert (state.z_cache is None) is (not from_train_z)
    _assert_run_matches(hist["train"], state, jax_metrics, jax_params)

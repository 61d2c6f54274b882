"""CPU parity of the port's model against the JAX package's MidiVAE.

The JAX side runs its full Pallas kernel tier in interpret mode
(``MidiVAE._interpret = True``); the port runs the same dispatch glue with
the kernels' plain versions (CPU tensors). Same parameters (the port's numpy
init is bit-equal), same numpy batch. Tolerance atol 1e-5 on z and on the
head outputs, argmax equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.evaluation.generation import transfer_argmax_graph as jax_transfer_graph
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu_torch import bridge
from midi_vae_tpu_torch.evaluation.generation import transfer_argmax_graph
from midi_vae_tpu_torch.models.vae import MidiVAE

ATOL = 1e-5
CONFIGS = {
    "default": {},
    "composer_input": {"decoder_input_composer": True},
    "no_history": {"history": False},
    "held_and_next": {"meta_held_notes": True, "meta_next_notes": True},
    "hard_sigmoid_plain": {"gate_activation": "hard_sigmoid"},
}


def make_batch(cfg, B, seed=0):
    rng = np.random.RandomState(seed)
    X = np.eye(cfg.input_dim, dtype=np.float32)[rng.randint(0, cfg.input_dim, (B, cfg.input_length))]
    I = np.eye(cfg.instrument_dim, dtype=np.float32)[rng.randint(0, cfg.instrument_dim, (B, cfg.max_voices))]
    V = rng.rand(B, cfg.output_length, 1).astype(np.float32)
    D = np.eye(2, dtype=np.float32)[rng.randint(0, 2, (B, cfg.output_length))]
    return {"X": X, "I": I, "V": V, "D": D}


def to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(cfg, jax model, jax params, port model, batch, jax outputs)."""
    cfg = small_test_config(**CONFIGS[request.param])
    jm = JaxVAE(cfg)
    jm._interpret = True
    params = jm.init_params(jax.random.PRNGKey(3))
    batch = make_batch(cfg, 5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    z = jm.encode(params, jb)
    rng = np.random.RandomState(1)
    H = jnp.asarray(rng.randn(5, cfg.latent_dim).astype(np.float32) * 0.5)
    A = jnp.asarray(np.eye(max(1, cfg.decoder_additional_input_dim), dtype=np.float32)[[0, 1, 0, 1, 1]]
                    if cfg.decoder_additional_input else np.zeros((5, 1), np.float32))
    heads = jm.decode(params, z, history=H, additional=A if cfg.decoder_additional_input else None,
                      inference=True)
    perm = np.arange(cfg.latent_dim)
    perm[[0, 1]] = [1, 0]
    idx, switched = jax_transfer_graph(jm, cfg, 0.0)(params, jb, jnp.asarray(perm), A, None)
    want = {"z": z, "H": H, "A": A, "heads": heads, "perm": perm, "idx": idx, "switched": switched}
    return cfg, MidiVAE(cfg, jax.tree_util.tree_map(np.asarray, params)), params, batch, want


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_bit_equal(name):
    cfg = small_test_config(**CONFIGS[name])
    want = bridge.flatten(JaxVAE(cfg).init_params(jax.random.PRNGKey(7)))
    got = bridge.flatten(MidiVAE(cfg).init_params(np.array([0, 7], np.uint32)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_bridge_round_trip(pair, tmp_path):
    _cfg, model, params, _batch, _want = pair
    flat = bridge.flatten(jax.tree_util.tree_map(np.asarray, params))
    back = bridge.flatten(bridge.to_tree(model.params))
    assert sorted(back) == sorted(flat)
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in model.params.parameters())
    bridge.save_params(str(tmp_path / "p.npz"), bridge.to_tree(model.params))
    loaded = bridge.flatten(bridge.load_params(str(tmp_path / "p.npz")))
    for k in flat:
        assert np.array_equal(back[k], flat[k]) and np.array_equal(loaded[k], flat[k]), k


def test_encode_matches_jax(pair):
    _cfg, model, _params, batch, want = pair
    with torch.inference_mode():
        z = model.encode(to_torch(batch))
    np.testing.assert_allclose(z.numpy(), np.asarray(want["z"]), rtol=0, atol=ATOL)


def test_decode_matches_jax(pair):
    cfg, model, _params, _batch, want = pair
    z = torch.from_numpy(np.asarray(want["z"]).copy())
    A = torch.from_numpy(np.asarray(want["A"]).copy())
    with torch.inference_mode():
        heads = model.decode(z, torch.from_numpy(np.asarray(want["H"]).copy()),
                             A if cfg.decoder_additional_input else None)
    assert sorted(heads) == sorted(want["heads"])
    for name, (probs, logits) in heads.items():
        wp, wl = (np.asarray(a) for a in want["heads"][name])
        np.testing.assert_allclose(probs.numpy(), wp, rtol=0, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(logits.numpy(), wl, rtol=0, atol=ATOL, err_msg=name)
        if name != "velocity":
            np.testing.assert_array_equal(probs.numpy().argmax(-1), wp.argmax(-1), err_msg=name)


def test_transfer_argmax_matches_jax(pair):
    cfg, model, _params, batch, want = pair
    fn = transfer_argmax_graph(model, cfg, 0.0)
    with torch.inference_mode():
        idx, switched = fn(to_torch(batch), torch.as_tensor(want["perm"]),
                           torch.from_numpy(np.asarray(want["A"]).copy()), None)
    np.testing.assert_allclose(switched.numpy(), np.asarray(want["switched"]), rtol=0, atol=ATOL)
    assert sorted(idx) == sorted(want["idx"])
    for k, v in idx.items():
        if k == "vel":
            np.testing.assert_allclose(v.numpy(), np.asarray(want["idx"][k]), rtol=0, atol=ATOL)
        else:
            np.testing.assert_array_equal(v.numpy(), np.asarray(want["idx"][k]), err_msg=k)


def test_kernel_switch_mirrors_jax():
    """Serving takes the kernel wrappers for GRU and LSTM cells with sigmoid
    gates (kernels A and B, L and M) on either device; on the CPU they run
    their plain versions. LSTM serving no longer raises on CUDA."""
    for overrides, enabled in (({}, True), ({"use_pallas": "off"}, False),
                               ({"gate_activation": "hard_sigmoid"}, False),
                               ({"cell_type": "SimpleRNN"}, False), ({"cell_type": "LSTM"}, True)):
        cfg = small_test_config(**overrides)
        for device in ("cpu", "cuda"):
            assert MidiVAE(cfg).kernels_enabled(torch.device(device)) is enabled, (overrides, device)


@pytest.mark.parametrize("cell_type", ["SimpleRNN", "LSTM"])
def test_plain_cells_match_jax(cell_type):
    """Cells without a ported kernel run the plain scan on the port; the
    JAX package runs them as plain scans on the CPU too."""
    cfg = small_test_config(cell_type=cell_type)
    jm = JaxVAE(cfg)
    params = jm.init_params(jax.random.PRNGKey(5))
    batch = make_batch(cfg, 3, seed=2)
    z = jm.encode(params, {k: jnp.asarray(v) for k, v in batch.items()})
    heads = jm.decode(params, z, inference=True)
    model = MidiVAE(cfg, jax.tree_util.tree_map(np.asarray, params))
    with torch.inference_mode():
        got_z = model.encode(to_torch(batch))
        got_heads = model.decode(got_z)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(z), rtol=0, atol=ATOL)
    for name, (probs, _logits) in got_heads.items():
        np.testing.assert_allclose(probs.numpy(), np.asarray(heads[name][0]), rtol=0, atol=ATOL,
                                   err_msg=name)

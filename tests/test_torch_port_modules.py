"""Port vs JAX: mel front-end, speech encoder, decoder, denoiser forward,
and the weight converter's round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture_diffusion_tpu.interop import import_torch_state_dict
from gesture_diffusion_tpu.models import GestureDenoiser as JaxDenoiser
from gesture_diffusion_tpu.models.decoders import OnewayCrossAttention as JaxDecoder
from gesture_diffusion_tpu.models.speech_encoder import HA2GSpeechEncoder as JaxHA2G
from gesture_diffusion_tpu.ops.audio import mel_filterbank as jax_fbank
from gesture_diffusion_tpu.ops.audio import speech_frontend as jax_frontend
from gesture_diffusion_torch.ops.audio import mel_filterbank, speech_frontend
from torch_port_common import (D_POSE, DM, T, inpaint_tensors, jax_variables,
                               port_model, rel_err, seeded_wav)

torch.set_num_threads(1)

# float32 both sides; the only differences are summation orders (FFT,
# convolution algorithms, matmuls), so 1e-5 of the output's max magnitude
FWD_TOL = 1e-5


@pytest.mark.parametrize("length", [8000, 8191])
def test_speech_frontend_matches(length):
    wav = seeded_wav(1, n=2, length=length)
    ref = np.asarray(jax_frontend(jnp.asarray(wav)))
    ours = speech_frontend(torch.from_numpy(wav)).numpy()
    assert ours.shape == ref.shape
    # instance-normalised mel (O(1) values); rfft of float32 frames on
    # both sides: 1e-4 absolute
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.mark.parametrize("htk,norm", [(True, None), (False, "slaney")])
def test_mel_filterbank_copy_matches(htk, norm):
    np.testing.assert_array_equal(mel_filterbank(513, 128, 16000, htk=htk, norm=norm),
                                  jax_fbank(513, 128, 16000, htk=htk, norm=norm))


@pytest.fixture(scope="module")
def s2g():
    wav = seeded_wav(2)
    cfg, variables = jax_variables("s2g_v2", n_layers=2, wav=wav, seed=3)
    return cfg, variables, port_model(cfg, variables), wav


def test_speech_encoder_matches(s2g):
    cfg, variables, model, wav = s2g
    enc = {"params": variables["params"]["speech_encoder"],
           "batch_stats": variables["batch_stats"]["speech_encoder"]}
    ref = JaxHA2G(cfg.d_model).apply(enc, jnp.asarray(wav), False)
    with torch.no_grad():
        ours = model.speech_encoder(torch.from_numpy(wav))
        mel = speech_frontend(torch.from_numpy(wav))
        trunk = model.speech_encoder.wav_encoder.feat_extractor(mel)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        assert rel_err(a.numpy(), b) < FWD_TOL
    # the SE-ResNet trunk alone (before the shared projection)
    from gesture_diffusion_tpu.models.speech_encoder import SEResNetEncoder

    trunk_ref = SEResNetEncoder().apply(
        {"params": enc["params"]["resnet"],
         "batch_stats": enc["batch_stats"]["resnet"]},
        jax_frontend(jnp.asarray(wav)), False)
    for a, b in zip(trunk, trunk_ref):
        assert rel_err(a.numpy(), b) < FWD_TOL


def test_bn_running_stats_carried_over(s2g):
    _, variables, model, _ = s2g
    bn = model.speech_encoder.wav_encoder.feat_extractor.layer2[0].bn1
    ref = variables["batch_stats"]["speech_encoder"]["resnet"]["layer2_block0"]["bn1"]
    np.testing.assert_array_equal(bn.running_mean.numpy(), ref["mean"])
    np.testing.assert_array_equal(bn.running_var.numpy(), ref["var"])
    assert not np.allclose(ref["var"], 1.0)


def test_oneway_decoder_matches(s2g):
    cfg, variables, model, _ = s2g
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, T, D_POSE)).astype(np.float32)
    mem = rng.normal(size=(2, 9, DM)).astype(np.float32)
    ref = JaxDecoder(d_x=D_POSE, d_memory=DM, d_model=DM, heads=cfg.heads,
                     n_layers=cfg.n_layers, d_out=D_POSE).apply(
        {"params": variables["params"]["decoder"]}, jnp.asarray(x),
        jnp.asarray(mem), False)
    with torch.no_grad():
        ours = model.pose_decoder(torch.from_numpy(x), torch.from_numpy(mem))
    assert rel_err(ours.numpy(), ref) < FWD_TOL


@pytest.mark.parametrize("model_type", ["s2g_v2", "default"])
def test_denoiser_methods_match(model_type):
    wav = seeded_wav(5)
    cfg, variables = jax_variables(model_type, n_layers=1, wav=wav, seed=6)
    model = port_model(cfg, variables)
    jm = JaxDenoiser(cfg)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, T, D_POSE)).astype(np.float32)
    t = np.array([3, 977], np.int64)
    jx, jt, jw = jnp.asarray(x), jnp.asarray(t.astype(np.int32)), jnp.asarray(wav)
    with torch.no_grad():
        mem = model.encode_memory(torch.from_numpy(wav))
        eps = model.denoise(torch.from_numpy(x), torch.from_numpy(t), mem)
        full = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(wav))
    ref_mem = jm.apply(variables, jw, method=JaxDenoiser.encode_memory)
    ref_eps = jm.apply(variables, jx, jt, ref_mem, method=JaxDenoiser.denoise)
    ref_full = jm.apply(variables, jx, jt, jw, train=False)
    assert mem.shape == ref_mem.shape
    assert rel_err(mem.numpy(), ref_mem) < FWD_TOL
    assert rel_err(eps.numpy(), ref_eps) < FWD_TOL
    assert rel_err(full.numpy(), ref_full) < FWD_TOL


def test_inpaint_denoiser_matches():
    """The inpaint model type: its conditioning MLP (kernels redrawn off
    their zero init by the harness), denoise and forward."""
    wav = seeded_wav(9)
    cfg, variables = jax_variables("inpaint", n_layers=1, wav=wav, seed=10)
    model = port_model(cfg, variables)
    jm = JaxDenoiser(cfg)
    x = np.random.default_rng(11).normal(size=(2, T, D_POSE)).astype(np.float32)
    t = np.array([3, 977], np.int64)
    ip, im = inpaint_tensors(12)
    jx, jt, jw = jnp.asarray(x), jnp.asarray(t.astype(np.int32)), jnp.asarray(wav)
    tx, tt, tip, tim = (torch.from_numpy(v) for v in (x, t, ip, im))
    with torch.no_grad():
        proj = model.inpaint_projection(tip, tim)
        mem = model.encode_memory(torch.from_numpy(wav))
        eps = model.denoise(tx, tt, mem, tip, tim)
        full = model(tx, tt, torch.from_numpy(wav), tip, tim)
        bare = model.pose_decoder(tx, torch.cat(
            [model.diffusion_step_encoder(tt)[:, None], mem], dim=1))
    ref_proj = jm.apply(variables, jnp.asarray(ip), jnp.asarray(im),
                        method=JaxDenoiser.inpaint_projection)
    ref_mem = jm.apply(variables, jw, method=JaxDenoiser.encode_memory)
    ref_eps = jm.apply(variables, jx, jt, ref_mem, method=JaxDenoiser.denoise,
                       inpaint_pose=jnp.asarray(ip), inpaint_mask=jnp.asarray(im))
    ref_full = jm.apply(variables, jx, jt, jw, train=False,
                        inpaint_pose=jnp.asarray(ip), inpaint_mask=jnp.asarray(im))
    assert proj.shape == ref_proj.shape == (2, T, D_POSE)
    assert np.abs(np.asarray(ref_proj)).max() > 0.05      # off the zero init
    assert rel_err(proj.numpy(), ref_proj) < FWD_TOL
    assert rel_err(eps.numpy(), ref_eps) < FWD_TOL
    assert rel_err(full.numpy(), ref_full) < FWD_TOL
    assert rel_err(bare.numpy(), ref_eps) > 1e-3          # the MLP is felt
    with pytest.raises(ValueError, match="inpaint tensors"):
        model.denoise(tx, tt, mem)


def test_inpaint_projection_starts_at_zero():
    """A freshly built inpaint model adds nothing (GLIDE-style zero init),
    and init_random_ moves the MLP off zero."""
    from gesture_diffusion_torch.models import (DenoiserConfig, GestureDenoiser,
                                                init_random_)

    model = GestureDenoiser(DenoiserConfig(d_pose=D_POSE, n_layers=1,
                                           model_type="inpaint")).eval()
    ip, im = (torch.from_numpy(v) for v in inpaint_tensors(13))
    with torch.no_grad():
        assert float(model.inpaint_projection(ip, im).abs().max()) == 0.0
        init_random_(model, torch.Generator().manual_seed(0))
        assert float(model.inpaint_projection(ip, im).abs().max()) > 1e-3


@pytest.mark.parametrize("model_type", ["s2g_v2", "default", "inpaint"])
def test_converter_round_trip(model_type):
    """import_torch_state_dict (the JAX package's own importer, an
    independent oracle) inverts state_dict_from_jax leaf by leaf."""
    cfg, variables = jax_variables(model_type, n_layers=2, seed=8)
    model = port_model(cfg, variables)
    back = import_torch_state_dict(model.state_dict(), cfg)
    flat_a = dict(jax.tree_util.tree_leaves_with_path(variables))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(jax.tree_util.keystr, flat_a)) == set(map(jax.tree_util.keystr, flat_b))
    for path, leaf in flat_a.items():
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(np.size(x) for x in jax.tree.leaves(variables["params"]))

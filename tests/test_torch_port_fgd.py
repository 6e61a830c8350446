"""Port vs JAX: the FGD evaluator (``generation/fgd.py``).

The motion autoencoder on the JAX package's flax variables, carried over
with ``motion_ae_state_dict_from_jax``; the Fréchet distance on seeded
covariances (full, complex and the ill-conditioned case that retries with
an eps offset); the evaluator's scores on the same features; the port's
save / load and the load of a JAX ``.msgpack`` net.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture_diffusion_tpu.generation import fgd as jax_fgd
from gesture_diffusion_torch.generation import fgd
from gesture_diffusion_torch.interop import motion_ae_state_dict_from_jax
from torch_port_common import rel_err

torch.set_num_threads(1)

# float32 both sides, sums in other orders: 1e-5 of max|ref|
TOL = 1e-5


def _windows(n, t, c, seed):
    rng = np.random.default_rng(seed)
    time = np.linspace(0, 2, t)[None, :, None]
    freqs = rng.uniform(0.5, 2.0, (n, 1, c))
    return (np.sin(2 * np.pi * freqs * time)
            + 0.05 * rng.normal(size=(n, t, c))).astype(np.float32)


def _nets(length, pose_dim, latent_dim=32, seed=0):
    """(flax MotionAE, its variables, the port's MotionAE on them)."""
    model = jax_fgd.MotionAE(length=length, pose_dim=pose_dim,
                             latent_dim=latent_dim)
    variables = jax.tree.map(np.asarray, model.init(
        jax.random.key(seed), jnp.zeros((2, length, pose_dim))))
    rng = np.random.default_rng(seed + 1)
    variables = jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), variables)
    ours = fgd.MotionAE(length, pose_dim, latent_dim)
    ours.load_state_dict(motion_ae_state_dict_from_jax(variables), strict=True)
    return model, variables, ours.eval()


@pytest.mark.parametrize("length,pose_dim", [(34, 126), (40, 123), (20, 12)],
                         ids=["tedexp", "beat", "small"])
def test_motion_ae_matches_jax(length, pose_dim):
    """encode and the full reconstruction on flax's weights."""
    model, variables, ours = _nets(length, pose_dim, latent_dim=16)
    x = _windows(5, length, pose_dim, 1)
    recon, feat = model.apply(variables, jnp.asarray(x))
    enc = model.apply(variables, jnp.asarray(x), method=jax_fgd.MotionAE.encode)
    with torch.no_grad():
        r, f = ours(torch.from_numpy(x))
        e = ours.encode(torch.from_numpy(x))
    assert r.shape == recon.shape and f.shape == feat.shape == (5, 16)
    assert rel_err(e.numpy(), np.asarray(enc)) < TOL
    assert rel_err(f.numpy(), np.asarray(feat)) < TOL
    assert rel_err(r.numpy(), np.asarray(recon)) < TOL


def _covs(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "full":
        a, b = rng.normal(size=(300, 6)), rng.normal(0.3, 1.2, (300, 6))
    elif kind == "rank_deficient":      # 5 samples in 12 dims: complex sqrtm
        a, b = rng.normal(size=(5, 12)), rng.normal(size=(5, 12))
    else:
        # a nilpotent product has no square root (sqrtm gives inf), the
        # eps-offset one has two positive eigenvalues
        return (rng.normal(size=2), np.array([[1.0, 0.0], [0.0, 0.0]]),
                rng.normal(size=2), np.array([[0.0, 1.0], [0.0, 0.0]]))
    return (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))


@pytest.mark.parametrize("kind", ["full", "rank_deficient", "ill_conditioned"])
def test_frechet_distance_equals_jax(kind, monkeypatch):
    """1e-9 relative; the ill-conditioned case takes the eps retry on both
    sides."""
    args = _covs(kind, 3)
    calls = []
    sqrtm = fgd._sqrtm
    monkeypatch.setattr(fgd, "_sqrtm", lambda a: calls.append(1) or sqrtm(a))
    ours = fgd.calculate_frechet_distance(*args)
    ref = jax_fgd.calculate_frechet_distance(*args)
    assert len(calls) == (2 if kind == "ill_conditioned" else 1)
    assert np.isfinite(ours)
    assert ours == pytest.approx(ref, rel=1e-9, abs=1e-12)


def test_evaluator_scores_equal_jax():
    """The same features give the same FGD, latent L1 and diversity; pose
    windows through each package's encoder give them to float32 noise."""
    length, pose_dim = 34, 126
    model, variables, ours = _nets(length, pose_dim)
    theirs = jax_fgd.EmbeddingSpaceEvaluator(model, variables)
    ev = fgd.EmbeddingSpaceEvaluator(ours)
    rng = np.random.default_rng(5)
    gen, real = rng.normal(size=(2, 64, 32))
    for e in (ev, theirs):
        e.generated_feat_list, e.real_feat_list = [gen[:40], gen[40:]], [real]
    assert ev.get_scores() == theirs.get_scores()
    assert ev.get_diversity_scores() == theirs.get_diversity_scores()
    assert ev.get_no_of_samples() == 64

    fake, true = _windows(48, length, pose_dim, 6), _windows(48, length, pose_dim, 7)
    for e in (ev, theirs):
        e.reset()
        e.push_samples(fake, true)
    (fd, dist), (fd_ref, dist_ref) = ev.get_scores(), theirs.get_scores()
    assert fd == pytest.approx(fd_ref, rel=1e-4)
    assert dist == pytest.approx(dist_ref, rel=1e-5)
    assert ev.get_diversity_scores() == pytest.approx(
        theirs.get_diversity_scores(), rel=1e-5)


def test_save_load_and_load_or_train(tmp_path):
    """Trained once, saved beside the configured path as .pt, loaded back
    bit for bit: two evaluations score the same."""
    poses = _windows(24, 20, 12, 8)
    cfg_path = str(tmp_path / "nets" / "fgd_ae.msgpack")
    net = fgd.load_or_train_motion_ae(cfg_path, poses, latent_dim=8, steps=5,
                                      device="cpu")
    pt = str(tmp_path / "nets" / "fgd_ae.pt")
    assert fgd.motion_ae_path(cfg_path) == pt
    assert os.path.exists(pt) and not os.path.exists(cfg_path)
    again = fgd.load_or_train_motion_ae(cfg_path, poses, steps=5, device="cpu")
    a, b = net.state_dict(), again.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert (again.length, again.pose_dim, again.latent_dim) == (20, 12, 8)
    with torch.no_grad():
        torch.testing.assert_close(net.encode(torch.from_numpy(poses)),
                                   again.encode(torch.from_numpy(poses)),
                                   rtol=0, atol=0)
    # training lowers the reconstruction error of the same seeded init
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        fresh = fgd.MotionAE(20, 12, 8)
    trained = fgd.train_motion_ae(poses, latent_dim=8, steps=60, device="cpu")
    with torch.no_grad():
        x = torch.from_numpy(poses)
        err0 = float((fresh(x)[0] - x).abs().mean())
        err1 = float((trained(x)[0] - x).abs().mean())
    assert err1 < err0


def test_jax_msgpack_net_raises(tmp_path):
    """A JAX package's net at the configured path, with no .pt beside it,
    is loaded (no longer refused; the test keeps its name) and never
    trained over: it scores as the JAX package scores with that file."""
    model, variables, _ = _nets(20, 12, latent_dim=8)
    path = str(tmp_path / "fgd_ae.msgpack")
    jax_fgd.save_motion_ae(path, model, variables)
    net = fgd.load_or_train_motion_ae(path, _windows(8, 20, 12, 9), steps=2,
                                      device="cpu")
    assert not os.path.exists(str(tmp_path / "fgd_ae.pt"))
    assert (net.length, net.pose_dim, net.latent_dim) == (20, 12, 8)
    ours = fgd.EmbeddingSpaceEvaluator(net)
    theirs = jax_fgd.EmbeddingSpaceEvaluator(*jax_fgd.load_motion_ae(path))
    fake, true = _windows(48, 20, 12, 6), _windows(48, 20, 12, 7)
    for e in (ours, theirs):
        e.push_samples(fake, true)
    (fd, dist), (fd_ref, dist_ref) = ours.get_scores(), theirs.get_scores()
    assert fd == pytest.approx(fd_ref, rel=1e-4)
    assert dist == pytest.approx(dist_ref, rel=1e-5)
    assert ours.get_diversity_scores() == pytest.approx(
        theirs.get_diversity_scores(), rel=1e-5)

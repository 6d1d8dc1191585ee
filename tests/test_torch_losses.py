"""The PyTorch port's losses against the JAX package's, on the CPU.

The same numpy `outs` go through `dh3d_tpu.losses` and
`dh3d_tpu_torch.losses`: values and gradients within 1e-5 relative (f32
sums in another order).  The detection loss's discrete choices (its kNN,
hardest negatives and match ranks) must fall the same way: the clouds are
checked to have no near tie at the k=16 boundary, because the JAX CPU kNN
builds distances with the matmul identity and the port with differences.
Also here: `knn_bruteforce_pairwise` at k=16 across clouds against the JAX
CPU op and against the exact Pallas kNN `_knn_kernel` in interpret mode
(the detection loss's queries, TPU kernel row 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dh3d_tpu import losses as JL
from dh3d_tpu import ops as J
from dh3d_tpu.config import get_config as jax_config
from dh3d_tpu.ops.pallas.knn_pallas import knn_pallas
from dh3d_tpu_torch import config as tcfg
from dh3d_tpu_torch import losses as TL
from dh3d_tpu_torch import ops as T

REL = 1e-5
P, N, M, D = 2, 128, 16, 32  # pairs, points, keypoints, descriptor width
DET_K = 16


def _close(a, ref, rel=REL):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    err = np.abs(a - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-12), (err,
                                                        np.abs(ref).max())


def _min_gap(points, queries, k):
    """Smallest relative gap between the k-th and (k+1)-th squared
    distance over all queries, in f64."""
    d = ((queries[:, :, None].astype(np.float64) - points[:, None]) ** 2
         ).sum(-1)
    ds = np.sort(d, axis=-1)
    return ((ds[..., k] - ds[..., k - 1]) / ds[..., k]).min()


def _l2n(x):
    return x / np.sqrt(np.maximum((x * x).sum(-1, keepdims=True), 1e-8))


def local_outs(seed, dup=False):
    """A synthetic self-pair `outs` dict as the train step's model gives it
    (sorted order does not matter here): clouds, keypoints, descriptors,
    scores and the warp R.  `dup` shrinks the cloud so that keypoint and
    hardest-negative neighbourhoods overlap (repeated candidate ids)."""
    rng = np.random.RandomState(seed)
    n = 40 if dup else N
    pc1 = (rng.randn(P, n, 3) * 5).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, P)
    R = np.stack([np.array([[np.cos(a), np.sin(a), 0],
                            [-np.sin(a), np.cos(a), 0], [0, 0, 1]])
                  for a in ang]).astype(np.float32)
    pc2 = np.einsum("bnd,bde->bne", pc1 + rng.randn(P, n, 3) * 0.02,
                    R).astype(np.float32)
    xyz = np.concatenate([pc1, pc2])
    anc = np.stack([rng.choice(n, M, replace=False) for _ in range(P)])
    inds = np.concatenate([anc, anc])
    feat = rng.randn(2 * P, n, D).astype(np.float32)
    take = np.take_along_axis
    return {
        "xyz": xyz, "feat": feat, "sample_nodes_concat": inds,
        "xyz_sampled": take(xyz, inds[..., None], axis=1),
        "feat_sampled": _l2n(take(feat, inds[..., None], axis=1)),
        "att_sampled": (1 / (1 + np.exp(-rng.randn(2 * P, M)))).astype(
            np.float32),
        "R": R}


def _run(loss_t, loss_j, outs, grad_keys, **kw):
    """Value, aux and gradients (w.r.t. `grad_keys`) of both losses."""
    t_in = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            outs.items()}
    t_in["sample_nodes_concat"] = t_in["sample_nodes_concat"].long()
    for k in grad_keys:
        t_in[k].requires_grad_()
    tv, taux = loss_t(t_in, **kw)
    tv.backward()
    tg = [np.zeros(outs[k].shape, np.float32) if t_in[k].grad is None
          else t_in[k].grad.numpy() for k in grad_keys]

    def f(*gs):
        j_in = {k: jnp.asarray(v) for k, v in outs.items()}
        j_in["sample_nodes_concat"] = j_in["sample_nodes_concat"].astype(
            jnp.int32)
        j_in.update(zip(grad_keys, gs))
        return loss_j(j_in, **kw)

    (jv, jaux), jg = jax.value_and_grad(f, argnums=tuple(
        range(len(grad_keys))), has_aux=True)(
            *[jnp.asarray(outs[k]) for k in grad_keys])
    return (tv.item(), {k: v.item() for k, v in taux.items()}, tg), \
        (float(jv), {k: float(v) for k, v in jaux.items()}, jg)


def _close_aux(taux, jaux, scale):
    """Loss components within REL of the loss's magnitude: a component
    that is a small difference (a hinge barely past its margin) carries
    the absolute rounding error of the whole."""
    assert set(taux) == set(jaux)
    for k in taux:
        assert abs(taux[k] - jaux[k]) <= REL * max(scale, abs(jaux[k])), k


@pytest.mark.parametrize("seed", [0, 3])
def test_desc_local_loss_matches_jax(seed):
    outs = local_outs(seed)
    (tv, ta, tg), (jv, ja, jg) = _run(
        TL.desc_local_loss, JL.desc_local_loss, outs, ["feat_sampled"],
        pos_r=0.5, search_r=20.0, margin=1.0, neg_weight=5.0)
    assert ta["num_pos"] == ja["num_pos"] > 0
    assert ta["num_neg"] == ja["num_neg"] > 0
    _close(tv, jv)
    _close_aux(ta, ja, abs(jv))
    _close(tg[0], jg[0])


@pytest.mark.parametrize("bug", [False, True])
@pytest.mark.parametrize("dup", [False, True])
def test_local_detection_loss_matches_jax(bug, dup):
    """Both `reproduce_ref_detloss_bug` branches, on a cloud where some
    candidate ids repeat (a keypoint's neighbourhood and its hardest
    negative's overlap) and on a small cloud where most do; the gradient
    reaches the scores only (AR is discrete).  The ranks must be the same:
    one rank step moves mean_ar by 0.2 / 32, far above rounding."""
    outs = local_outs(0 if dup else 2, dup=dup)  # seeds with no near tie
    xyz1 = outs["xyz"][P:]
    assert _min_gap(xyz1, xyz1, DET_K) > 1e-4  # no near tie at k=16
    kw = dict(ar_th=0.4, det_k=DET_K, ar_nn_k=5, pos_r=0.5,
              reproduce_ref_detloss_bug=bug)
    (tv, ta, tg), (jv, ja, jg) = _run(
        TL.local_detection_loss_nn, JL.local_detection_loss_nn, outs,
        ["att_sampled", "feat_sampled"], **kw)
    _close(tv, jv)
    assert abs(ta["mean_ar"] - ja["mean_ar"]) < 1e-6
    _close(tg[0], jg[0])
    assert not np.asarray(jg[1]).any() and not tg[1].any()
    t_outs = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in outs.items()}
    t_outs["sample_nodes_concat"] = t_outs["sample_nodes_concat"].long()
    _, cand = TL.detection_ranks(t_outs, DET_K, 5, 0.5,
                                 reproduce_ref_detloss_bug=bug)
    repeats = [len(r) - len(set(r)) for r in cand.reshape(-1, 2 * DET_K)
               .tolist()]
    assert sum(repeats) > 0


def _global_descs(seed, total):
    rng = np.random.RandomState(seed)
    return _l2n(rng.randn(total, 256)).astype(np.float32)


@pytest.mark.parametrize("name", ["lazy_triplet_loss", "lazy_quadruplet_loss",
                                  "batch_hard_triplet_loss",
                                  "batch_hard_quadruplet_loss"])
def test_global_losses_match_jax(name):
    bs, pos, neg = 2, 2, 3
    other = name.endswith("quadruplet_loss")
    g = _global_descs(1, bs * (1 + pos + neg + (1 if other else 0)))
    kw = dict(batch_size=bs, num_pos=pos, num_neg=neg,
              global_triplet_margin=0.5, global_quadruplet_margin=0.2)
    tg = torch.from_numpy(g).requires_grad_()
    tv, taux = TL.GLOBAL_LOSSES[name](tg, **kw)
    tv.backward()
    (jv, jaux), jgrad = jax.value_and_grad(
        lambda x: JL.GLOBAL_LOSSES[name](x, **kw), has_aux=True)(
            jnp.asarray(g))
    assert float(jv) > 0
    _close(tv.item(), float(jv))
    _close_aux({k: v.item() for k, v in taux.items()},
               {k: float(v) for k, v in jaux.items()}, float(jv))
    _close(tg.grad.numpy(), jgrad)


def test_batch_hard_across_processes_is_not_ported():
    g = torch.from_numpy(_global_descs(2, 12))
    with pytest.raises(NotImplementedError):
        TL.batch_hard_triplet_loss(g, 2, 2, 3, axis_name="data")


@pytest.mark.parametrize("name", ["detection_config", "global_config"])
def test_compute_total_loss_matches_jax(name):
    """The dispatch, the weights and the weight-decay term."""
    jc, tc = jax_config(name), tcfg.get_config(name)
    for c in (jc, tc):
        c.batch_size, c.num_pos, c.num_neg = 2, 2, 3
    outs = local_outs(2)
    outs["global_desc"] = _global_descs(3, 2 * (1 + 2 + 3 + 1))
    t_outs = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in outs.items()}
    t_outs["sample_nodes_concat"] = t_outs["sample_nodes_concat"].long()
    j_outs = {k: jnp.asarray(v) for k, v in outs.items()}
    tt, tm = TL.compute_total_loss(t_outs, tc, torch.tensor(3.0))
    jt, jm = JL.compute_total_loss(j_outs, jc, jnp.float32(3.0))
    _close_aux({k: float(v) for k, v in tm.items()},
               {k: float(v) for k, v in jm.items()}, float(jt))
    _close(float(tt), float(jt))


def test_pairwise_distances_match_jax(rng):
    a = rng.randn(2, 9, 16).astype(np.float32)
    b = rng.randn(2, 11, 16).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(TL.pairwise_dist(ta, tb).numpy(),
           JL.pairwise_dist(jnp.asarray(a), jnp.asarray(b)))
    _close(TL.pairwise_dist_matmul(ta, tb).numpy(),
           JL.losses.pairwise_dist_matmul(jnp.asarray(a), jnp.asarray(b)))
    _close(TL.pairwise_dist_cosine(ta, tb).numpy(),
           JL.pairwise_dist_cosine(jnp.asarray(a), jnp.asarray(b)))


# ------------------ kernel A at k=16 across clouds (row 3) ------------------

def test_knn_pairwise_k16_matches_jax_and_exact_pallas():
    """Keypoint queries against a whole cloud, k=16: indices equal to the
    JAX CPU op (matmul-identity distances, the clouds checked for no near
    tie) and to `knn_pallas(query, keys, 16)`, the exact `_knn_kernel`, in
    interpret mode.  Squared distances within 1e-6 of max |q|^2 + |k|^2:
    both JAX forms build them with the matmul identity, whose f32
    cancellation costs a few ulps of those norms (the port subtracts
    first)."""
    rng = np.random.RandomState(16)
    keys = (rng.randn(2, 512, 3) * 5).astype(np.float32)
    query = np.ascontiguousarray(keys[:, rng.choice(512, 64, replace=False)]
                                 + 0.01)
    assert _min_gap(keys, query, DET_K) > 1e-4
    ti, td = T.knn_bruteforce_pairwise(torch.from_numpy(query),
                                       torch.from_numpy(keys), DET_K)
    ji, jd = J.knn_bruteforce_pairwise(jnp.asarray(query), jnp.asarray(keys),
                                       DET_K)
    d2 = td.numpy().astype(np.float64) ** 2
    atol = 1e-6 * ((query ** 2).sum(-1).max() + (keys ** 2).sum(-1).max())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d2, np.asarray(jd, np.float64) ** 2, rtol=0,
                               atol=atol)
    pi, pd = knn_pallas(jnp.asarray(query), jnp.asarray(keys), DET_K,
                        interpret=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_allclose(d2, np.asarray(pd), rtol=0, atol=atol)

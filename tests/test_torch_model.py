"""The PyTorch port's whole forward against the JAX package's, on the CPU.

The same numpy clouds go through `dh3d_tpu` (JAX on the CPU, which takes
its plain gather ops there) and `dh3d_tpu_torch` (whose wrappers take their
plain versions for CPU tensors), with the same weights carried across by
`dh3d_tpu_torch.nn.convert`.  Indices and coordinates must be equal.
Float outputs differ only by summation order and by the JAX kNN's matmul
distance identity (it feeds the 3-NN weights): ATOL for unit-scale outputs
(the l2-normalised descriptors, attention in [0, 1]); `feat` (unnormalised,
up to ~1e9 under random init) is held to RTOL of its largest magnitude.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dh3d_tpu import config as jcfg
from dh3d_tpu.eval.extract import make_forward as jax_make_forward
from dh3d_tpu.nn import DH3D as JaxDH3D
from dh3d_tpu.nn import init_variables
from dh3d_tpu.train import resolve_model
from dh3d_tpu_torch import config as tcfg
from dh3d_tpu_torch.entry import entry_config, entry_points, entry_weights
from dh3d_tpu_torch.eval import make_forward
from dh3d_tpu_torch.nn import DH3D, load_flax, load_npz
from dh3d_tpu_torch.nn.convert import torch_name

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
N = 512  # a few FPS levels deep (512 -> 64) and quick on the CPU
ATOL = 1e-4
RTOL = 1e-5

EXACT = ("xyz", "knn_indices")
FLOAT = ("local_desc", "attention", "global_desc", "xyz_feat",
         "xyz_feat_att")


def flatten_variables(variables, prefix=""):
    """Flax variables {collection: {module: ...: array}} -> the flat
    {"collection/module/.../name": array} layout of `models/*.npz`."""
    flat = {}
    for k, v in variables.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            flat.update(flatten_variables(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _compare(jax_outs, torch_outs):
    assert set(torch_outs) == set(jax_outs) - {"oob_overflow"}
    for key, t in torch_outs.items():
        j = np.asarray(jax_outs[key])
        t = t.numpy()
        assert t.shape == j.shape, key
        if key in EXACT:
            np.testing.assert_array_equal(t, j, err_msg=key)
        elif key == "feat":
            scale = np.abs(j).max()
            assert np.abs(t - j).max() <= RTOL * scale, key
        else:
            assert key in FLOAT, key
            np.testing.assert_allclose(t, j, rtol=0, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_entry_forward_random_init_matches_jax(scale):
    """The main-path config (global_config + detection, Morton order) with
    JAX `init_variables` weights.  scale=1 keeps the attention sigmoid off
    its rails; scale=30 is the bench's cloud scale."""
    jc = jcfg.get_config("global_config")
    jc.detection = True
    jc.detection_block = "detection_block"
    variables = init_variables(jc, jax.random.PRNGKey(0))
    pts = entry_points(2, N, seed=1) * np.float32(scale / 30.0)
    jo = jax.jit(lambda v, p: JaxDH3D(jc).apply(v, p, train=False))(
        variables, jnp.asarray(pts))

    cfg = entry_config()
    model = DH3D(cfg)
    flat = flatten_variables(variables)
    assert load_flax(model, flat) == len(flat)
    _compare(jo, make_forward(cfg, model)(pts))


def test_forward_with_given_knn_and_keypoints_matches_jax():
    """The other inputs and outputs of the forward: host-given neighbour
    ids (`knn_inds`, mapped into Morton order), keypoint ids
    (`sample_inds`: xyz/feat/att_sampled) and the global subsample."""
    jc = jcfg.get_config("global_config")
    jc.detection = True
    jc.sampled_kpnum = 16
    jc.global_subsample = 32
    variables = init_variables(jc, jax.random.PRNGKey(1))
    pts = entry_points(2, N, seed=4) / np.float32(30.0)
    from dh3d_tpu_torch.ops import knn_bruteforce

    knn, _ = knn_bruteforce(torch.from_numpy(pts), 8)
    kp = np.random.RandomState(4).randint(0, N, (2, 16))
    jo = JaxDH3D(jc).apply(variables, jnp.asarray(pts),
                           knn_inds=jnp.asarray(knn.numpy(), jnp.int32),
                           sample_inds=jnp.asarray(kp, jnp.int32),
                           train=False)

    cfg = entry_config()
    cfg.sampled_kpnum = 16
    cfg.global_subsample = 32
    model = DH3D(cfg).eval()  # a module starts in train mode
    load_flax(model, flatten_variables(variables))
    with torch.no_grad():
        to = model(torch.from_numpy(pts), knn_inds=knn,
                   sample_inds=torch.from_numpy(kp))
    assert {"xyz_sampled", "feat_sampled", "att_sampled",
            "sample_nodes_concat"} <= set(to)
    np.testing.assert_array_equal(to.pop("sample_nodes_concat").numpy(),
                                  np.asarray(jo["sample_nodes_concat"]))
    np.testing.assert_array_equal(to.pop("xyz_sampled").numpy(),
                                  np.asarray(jo["xyz_sampled"]))
    for key in ("feat_sampled", "att_sampled"):
        np.testing.assert_allclose(to.pop(key).numpy(), np.asarray(jo[key]),
                                   rtol=0, atol=ATOL, err_msg=key)
    _compare({k: v for k, v in jo.items() if k in to}, to)


@pytest.mark.parametrize("stem,n_arrays", [("demo_stage3", 92),
                                           ("demo_stage2", 81)])
def test_demo_checkpoint_forward_matches_jax(stem, n_arrays):
    """Each committed checkpoint under its own config.json, through both
    extraction forwards, with the eval CLIs' override of sampled_kpnum."""
    pts = entry_points(2, N, seed=2) / np.float32(30.0)  # unit scale

    jc, variables = resolve_model(os.path.join(MODELS, stem))
    jc.sampled_kpnum = -1
    jo = jax_make_forward(jc, variables)(pts)

    cfg = tcfg.load_config(os.path.join(MODELS, f"{stem}.config.json"))
    cfg.sampled_kpnum = -1
    model = DH3D(cfg)
    flat = load_npz(os.path.join(MODELS, f"{stem}.npz"))
    assert len(flat) == n_arrays
    assert load_flax(model, flat) == n_arrays
    fwd = make_forward(cfg, model)
    assert cfg.morton_presorted is False
    _compare(jo, fwd(pts))


def test_entry_weights_cover_the_entry_model():
    flat = entry_weights()
    assert sum("detection_block/" in k for k in flat) == 20
    assert load_flax(DH3D(entry_config()), flat) == 92 + 20


def test_converter_rejects_leftover_and_missing_arrays():
    flat = load_npz(os.path.join(MODELS, "demo_stage2.npz"))
    cfg = tcfg.load_config(os.path.join(MODELS, "demo_stage2.config.json"))
    extra = dict(flat)
    extra["params/local_backbone/stray/kernel"] = np.zeros((2, 2), np.float32)
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_flax(DH3D(cfg), extra)
    missing = {k: v for k, v in flat.items() if not k.endswith("/theta")}
    with pytest.raises(RuntimeError, match="Missing"):
        load_flax(DH3D(cfg), missing)


def test_converter_names_and_layouts():
    assert torch_name("params/a/dense/kernel") == ("a.dense.weight", True)
    assert torch_name("params/a/norm/bn/scale") == ("a.norm.scale", False)
    assert torch_name("batch_stats/a/norm/bn/var") == ("a.norm.var", False)
    assert torch_name("params/g/cluster_weights2") == ("g.cluster_weights2",
                                                       False)
    model = DH3D(tcfg.load_config(
        os.path.join(MODELS, "demo_stage2.config.json")))
    flat = load_npz(os.path.join(MODELS, "demo_stage2.npz"))
    load_flax(model, flat)
    k = flat["params/detection_block/detec_conv1/dense/kernel"]
    w = model.detection_block.detec_conv1.dense.weight.detach().numpy()
    np.testing.assert_array_equal(w, k.T)


def test_port_imports_no_jax():
    """The port must run where jax and sklearn are not installed."""
    code = (
        "import sys\n"
        "import dh3d_tpu_torch, dh3d_tpu_torch.kernels, dh3d_tpu_torch.ops\n"
        "import dh3d_tpu_torch.nn, dh3d_tpu_torch.eval, dh3d_tpu_torch.entry\n"
        "import dh3d_tpu_torch.losses, dh3d_tpu_torch.train\n"
        "import dh3d_tpu_torch.train.__main__, dh3d_tpu_torch.data\n"
        "import dh3d_tpu_torch.data.synthetic, dh3d_tpu_torch.eval.nms\n"
        "import dh3d_tpu_torch.eval.retrieval, dh3d_tpu_torch.evaluate\n"
        "import dh3d_tpu_torch.evaluate.localdesc_extract\n"
        "import dh3d_tpu_torch.evaluate.globaldesc_extract\n"
        "import dh3d_tpu_torch.data.augment, dh3d_tpu_torch.data.pairgen\n"
        "import dh3d_tpu_torch.data.prefetch, dh3d_tpu_torch.train.data\n"
        "import dh3d_tpu_torch.utils.transforms\n"
        "import dh3d_tpu_torch.eval.registration\n"
        "import dh3d_tpu_torch.eval.repeatability\n"
        "import dh3d_tpu_torch.eval.matlab_extras\n"
        "import dh3d_tpu_torch.evaluate.relocalize\n"
        "import dh3d_tpu_torch.evaluate.registration_eval\n"
        "import dh3d_tpu_torch.evaluate.repeatability_eval\n"
        "import dh3d_tpu_torch.evaluate.error_budget\n"
        "import dh3d_tpu_torch.ops.knn, dh3d_tpu_torch.ops.flex\n"
        "import dh3d_tpu_torch.ops.grouping, dh3d_tpu_torch.ops.sampling\n"
        "import dh3d_tpu_torch.ops.interpolate, dh3d_tpu_torch.nn.layers\n"
        "import dh3d_tpu_torch.bench, dh3d_tpu_torch.scripts\n"
        "import dh3d_tpu_torch.parallel, dh3d_tpu_torch.parallel.launch\n"
        "import dh3d_tpu_torch.parallel.jobs\n"
        "import dh3d_tpu_torch.parallel.collectives\n"
        "import dh3d_tpu_torch.parallel.mesh\n"
        "import dh3d_tpu_torch.parallel.sharded_knn\n"
        "import dh3d_tpu_torch.scripts.package_checkpoint\n"
        "import dh3d_tpu_torch.scripts.train_demo_curriculum\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'dh3d_tpu', 'sklearn'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_unported_options_raise():
    """The model refuses a compute_dtype it does not run (float16); the
    bf16 compute_dtype runs since it was ported
    (`tests/test_torch_bf16.py` holds it to the JAX model), and so does
    the legacy morton_exact=False mode (`tests/test_torch_window.py`)."""
    cfg = entry_config()
    cfg.compute_dtype = "float16"
    with pytest.raises(NotImplementedError):
        DH3D(cfg)
    cfg = entry_config()
    cfg.compute_dtype = "bfloat16"
    DH3D(cfg)
    cfg = entry_config()
    cfg.morton_exact = False
    DH3D(cfg)


def test_forward_keeps_knn_indices_in_sorted_space():
    """knn_indices stay in Morton-sorted space (`model.py:133`) while the
    dense outputs come back in input order."""
    cfg = entry_config()
    model = DH3D(cfg)
    pts = torch.from_numpy(entry_points(1, 256, seed=3))
    outs = make_forward(cfg, model)(pts)
    torch.testing.assert_close(outs["xyz"], pts, rtol=0, atol=0)
    from dh3d_tpu_torch.ops import knn_bruteforce, morton_perm

    perm, _ = morton_perm(pts)
    sorted_pts = pts[0, perm[0]][None].contiguous()
    idx, _ = knn_bruteforce(sorted_pts, 8)
    torch.testing.assert_close(outs["knn_indices"], idx, rtol=0, atol=0)

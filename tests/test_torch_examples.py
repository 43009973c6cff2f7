"""The port's five examples (``examples/torch_*.py``) and the helpers they
added to the port (``data.synthetic.make_md_trajectory``,
``make_noisy_replicas``, ``core.metrics.elbow``), on the CPU.

The helpers are numpy and equal the reference's bit for bit, from the same
``default_rng`` streams. The activation features of
``torch_cluster_activations`` from the reference's f32 parameters
(converted by ``convert.lm_params_from_numpy``) match the reference's
mean-pooled ``forward`` within 1e-5 normwise (f32; the forward's sums are
ordered differently). Each example's ``main`` runs at small arguments
with ``--device cpu``; its quality bound is the reference example's own
result at the same arguments, measured once (the reference examples are
not run here), less 0.02, since randomness does not cross the port
(parameters, k-means++ and landmark draws are the port's own):

- ``examples/quickstart.py`` (it takes no arguments; the port's defaults
  are its sizes): 2D toy acc 0.801 nmi 0.517, sparse landmarks acc 0.800
  nmi 0.515, XOR blobs linear acc 0.500, kernel acc 1.000;
- ``examples/cluster_md_trajectory.py --frames 4000 --atoms 8 --states 4
  --restarts 2 --memory-gb 0.005``: B = 4, acc 1.0000 nmi 1.0000;
  with ``--elbow`` C* = 6 of (4, 6, 8, 10, 12);
- ``examples/cluster_activations.py --seqs 256 --seq-len 32 --batches
  2``: acc 1.000 nmi 1.000.

``torch_cluster_md_trajectory.py --mesh 2x2`` runs in a spawned gloo
world of 4 (every rank the same medoids), ``torch_train_lm.py`` resumes
from its own checkpoint, and ``torch_serve_lm.py`` serves its requests.
"""
import datetime
import importlib.util
import os
import pickle
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MD_ARGS = ["--frames", "4000", "--atoms", "8", "--states", "4",
           "--restarts", "2", "--memory-gb", "0.005"]
ACT_ARGS = ["--seqs", "256", "--seq-len", "32", "--batches", "2"]
SLACK = 0.02
DEADLINE = 240.0


def _example(name):
    """The module of ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the helpers, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(2000, 8, 4, 400.0, 0),
                                  (3000, 16, 20, 50.0, 3)])
def test_make_md_trajectory_equals_the_reference(args):
    from repro.data.synthetic import make_md_trajectory as ref
    from repro_torch.data.synthetic import make_md_trajectory
    n, atoms, states, dwell, seed = args
    x, y = make_md_trajectory(n, atoms, states, dwell=dwell, seed=seed)
    xr, yr = ref(n, atoms, states, dwell=dwell, seed=seed)
    assert x.dtype == xr.dtype and y.dtype == yr.dtype
    np.testing.assert_array_equal(x, xr)
    np.testing.assert_array_equal(y, yr)


def test_make_noisy_replicas_equals_the_reference():
    from repro.data.synthetic import make_mnist_like
    from repro.data.synthetic import make_noisy_replicas as ref
    from repro_torch.data.synthetic import make_noisy_replicas
    x, y = make_mnist_like(300, seed=1)
    got = make_noisy_replicas(x, y, n_replicas=4, frac_features=0.3, seed=2)
    want = ref(x, y, n_replicas=4, frac_features=0.3, seed=2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("costs", [[9.0, 5.0, 4.0, 3.8, 3.7],
                                   [1.0, 2.0], [3.0, 3.0, 3.0, 3.0],
                                   [10.0, 4.0, 3.0, 1.0, 0.9, 0.8]])
def test_elbow_equals_the_reference(costs):
    from repro.core.metrics import elbow as ref
    from repro_torch.core import elbow
    assert elbow(costs) == ref(costs)


def test_topic_stream_equals_the_reference():
    want = _example("cluster_activations").topic_stream(256, 5, 64, 16,
                                                        seed=3)
    got = _example("torch_cluster_activations").topic_stream(256, 5, 64, 16,
                                                             seed=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the activation features against the reference's forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["rwkv6-7b", "olmo-1b", "zamba2-2.7b"])
def test_activation_features_match_the_reference(arch):
    from repro.configs import get_arch as jax_get_arch
    from repro.distributed.compat import make_mesh
    from repro.models import Axes
    from repro.models import get_model as jax_get_model
    from repro_torch import convert
    from repro_torch.configs import get_arch
    ex = _example("torch_cluster_activations")
    jcfg = jax_get_arch(arch, smoke=True)
    jparams, _ = jax_get_model(jcfg, tp_size=1).init(jax.random.PRNGKey(0),
                                                     jnp.float32)
    cfg = get_arch(arch, smoke=True)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          cfg, "cpu", torch.float32)
    tokens, _ = ex.topic_stream(cfg.vocab_size, 5, 24, 16)
    if cfg.family == "ssm":
        from repro.models.rwkv import forward
    elif cfg.family == "hybrid":
        from repro.models.zamba import forward
    else:
        from repro.models.transformer import forward
    axes = Axes(dp=("data",), tp="model")
    with make_mesh((1, 1), ("data", "model")):
        want = np.asarray(jnp.mean(forward(
            jparams, jnp.asarray(tokens), jcfg, axes, remat=False)[0]
            .astype(jnp.float32), axis=1))
    got = ex.features(params, tokens, cfg, torch.device("cpu"), chunk=16)
    assert got.shape == want.shape == (24, cfg.d_model)
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


# ---------------------------------------------------------------------------
# the examples' mains
# ---------------------------------------------------------------------------


def test_quickstart_runs_at_the_reference_quality():
    out = _example("torch_quickstart").main(["--device", "cpu"])
    assert out["toy_acc"] >= 0.801 - SLACK
    assert out["toy_nmi"] >= 0.517 - SLACK
    assert out["sparse_acc"] >= 0.800 - SLACK
    assert out["sparse_nmi"] >= 0.515 - SLACK
    assert out["xor_kernel_acc"] >= 1.000 - SLACK
    assert out["xor_kernel_acc"] > out["xor_linear_acc"]


def test_md_trajectory_runs_at_the_reference_quality():
    out = _example("torch_cluster_md_trajectory").main(
        MD_ARGS + ["--device", "cpu"])
    assert out["b"] == 4 and out["s"] == 1.0        # the reference's plan
    assert out["acc"] >= 1.0 - SLACK
    assert out["nmi"] >= 1.0 - SLACK
    assert out["checkpoints"] == 3                  # one a batch, from 0


def test_md_trajectory_elbow_picks_from_the_sweep():
    out = _example("torch_cluster_md_trajectory").main(
        MD_ARGS[:-4] + ["--restarts", "1", "--memory-gb", "0.005",
                        "--elbow", "--device", "cpu"])
    assert out["elbow"]["cs"] == [4, 6, 8, 10, 12]
    assert len(out["elbow"]["costs"]) == 5
    assert out["elbow"]["c"] in out["elbow"]["cs"]
    assert out["acc"] >= 1.0 - SLACK                # C* >= the 4 states


def _md_child(rank, world, store, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        got = _example("torch_cluster_md_trajectory").main(
            MD_ARGS + ["--mesh", "2x2", "--device", "cpu"])
    except Exception:
        got = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()


def test_md_trajectory_mesh_2x2_in_a_gloo_world(tmp_path):
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_md_child, args=(4, str(tmp_path / "store"),
                                              str(tmp_path)),
                             nprocs=4, join=False, start_method="spawn")
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() - t0 > DEADLINE:
                pytest.fail(f"the world of 4 passed its {DEADLINE} s "
                            f"deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for r in range(4):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
        assert "error" not in ranks[-1], ranks[-1]["error"]
    for got in ranks:
        assert got["b"] == 2         # the plan's budget is 4 ranks' memory
        assert got["acc"] >= 1.0 - SLACK and got["nmi"] >= 1.0 - SLACK
        assert (got["acc"], got["nmi"], got["cost"]) == \
            (ranks[0]["acc"], ranks[0]["nmi"], ranks[0]["cost"])
    assert ranks[0]["checkpoints"] == 1


def test_cluster_activations_runs_at_the_reference_quality():
    out = _example("torch_cluster_activations").main(
        ACT_ARGS + ["--device", "cpu"])
    assert out["acc"] >= 1.000 - SLACK
    assert out["nmi"] >= 1.000 - SLACK


def test_train_lm_resumes_from_its_checkpoint(tmp_path, capsys):
    ex = _example("torch_train_lm")
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    first = ex.main(argv + ["--steps", "50"])    # a checkpoint every 50
    assert len(first.losses) == 50 and np.all(np.isfinite(first.losses))
    capsys.readouterr()
    again = ex.main(argv + ["--steps", "100"])
    assert "[train] resumed from step 50" in capsys.readouterr().out
    assert len(again.losses) == 50 and np.all(np.isfinite(again.losses))


def test_serve_lm_serves_every_request():
    out = _example("torch_serve_lm").main(["--device", "cpu", "--requests",
                                           "3"])
    assert sorted(out) == [1, 2, 3]
    assert all(len(v) == 12 for v in out.values())

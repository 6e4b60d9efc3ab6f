"""The port's data-parallel training over `torch.distributed` against the
JAX package's `shard_map` on two CPU devices.

One gloo pair (world 2, the CPU) is started once for the file: this file,
run as a script (`python tests/test_torch_distributed.py --rank R --dir
D`), is each rank, and imports only the port. The test process writes the
inputs (pickled port trainers, the seeded states as JAX-path arrays, the
batches, JAX's draws), starts the pair, computes the JAX references while
the ranks run, and reads each rank's results back. The ranks run, in
order: one flagship-family train step, each rank on half of the batch,
against JAX's step over the whole batch on `Mesh(jax.devices()[:2])` from
the same state and key (the bars of tests/test_train_parity.py); the
Avocodo trainer's gradients and metrics; a shape-gain VQ training pass;
the k-means init on the gathered batch and on rank 0's rows;
`process_mean`; the replica check on a planted divergence; and a
two-epoch `TrainLoop` in two runs (the second resumes), where only rank 0
writes checkpoints and summaries. One more test runs the step in process
in a gloo group of one rank, which must equal the step without a group
bit for bit.
"""

import argparse
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
B, FRAMES = 4, 128          # the whole batch; each rank takes B // 2
SG_ROWS = 20                # shape-gain latents a rank: [1, 8, 20]


# -- the ranks ------------------------------------------------------------------
def _load(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return pickle.load(f)


def _half(x, rank):
    h = x.shape[0] // 2
    return x[rank * h:(rank + 1) * h]


def _rank_main(rank: int, d: str) -> None:
    import torch.distributed as dist

    from hilcodec_tpu_torch.parallel import dist as D
    from hilcodec_tpu_torch.train.loop import TrainLoop
    from hilcodec_tpu_torch.utils import params as P
    from hilcodec_tpu_torch.utils import summarize as S
    from hilcodec_tpu_torch.utils.hparams import load_config

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            world_size=2, rank=rank)
    group = D.default_group()
    out = {}
    inp = _load(d, "inputs.pkl")

    # one flagship train step on this rank's half of the batch
    f = inp["flagship"]
    tr = dataclasses.replace(f["trainer"], group=group)
    ts = P.tree_from_flat(f["flat"], tr.init_state(torch.Generator()))
    wav = torch.from_numpy(_half(f["wav"], rank))
    aux = tr.compute_grads(ts, wav, f["draws"])
    ts_next, m = tr.train_step(ts, wav, f["draws"])
    out["flagship"] = dict(taux=aux, ts=ts, ts_next=ts_next, tm=m,
                           flat_next=P.tree_to_flat(ts_next))

    # the Avocodo trainer's gradients and metrics
    a = inp["avocodo"]
    tr = dataclasses.replace(a["trainer"], group=group)
    ts = P.tree_from_flat(a["flat"], tr.init_state(torch.Generator()))
    aux = tr.compute_grads(ts, torch.from_numpy(_half(a["wav"], rank)),
                           a["draws"])
    _, m = tr.apply_grads(ts, aux)
    out["avocodo"] = dict(taux=aux, tm=m)

    # a shape-gain training pass
    s = inp["shape_gain"]
    x = torch.from_numpy(_half(s["x"], rank))
    out["shape_gain"] = s["vq"](x, s["state"], s["draws"], group=group)

    # k-means: on the batch gathered in rank order, and on rank 0's rows
    k = inp["kmeans"]
    z = torch.from_numpy(_half(k["z"], rank))
    gathered = D.all_gather_rows(z, group)
    out["kmeans"] = dict(
        gathered=gathered,
        full=k["vq"].kmeans_init_state(k["state"], gathered, k["idx_full"]),
        rank0=k["vq"].kmeans_init_state(k["state"], z, k["idx_half"],
                                        group=group))

    out["process_mean"] = D.process_mean(float(rank + 1), float(rank + 1))
    out["host_sums"] = D.all_sum_host([rank, 1.5], group)

    tree = {"a": torch.arange(6.0), "b": [torch.ones(3), torch.zeros(2)]}
    D.assert_replicas_consistent(tree)
    if rank == 1:
        tree["b"][0] = tree["b"][0] + 1e-3
    try:
        D.assert_replicas_consistent(tree)
        out["divergence"] = None
    except AssertionError as e:
        out["divergence"] = str(e)

    # two epochs of the loop in two runs: the second resumes
    opened = []
    get_writer = S.get_writer
    S.get_writer = lambda path: opened.append(path) or get_writer(path)
    hps = load_config(os.path.join(d, "loop.yaml"))
    run_dir = os.path.join(d, "run")
    first = TrainLoop(hps, run_dir=run_dir, device="cpu")
    first.run(max_epochs=1)
    second = TrainLoop(hps, run_dir=run_dir, device="cpu")
    second.init_or_resume()
    resumed_at = second.epoch
    second.run(max_epochs=2)
    out["loop"] = dict(
        resumed_at=resumed_at, epoch=second.epoch, n_proc=second.n_proc,
        writers=len(opened),
        shard=(second.train_loader.num_shards, second.train_loader.shard),
        state=P.tree_to_flat(second.state))

    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test process -----------------------------------------------------------
def _write_inputs(d):
    """Inputs of both ranks, and the JAX side of each check."""
    import jax
    import jax.numpy as jnp

    from hilcodec_tpu.ops import shape_gain as JSG
    from hilcodec_tpu.ops.rvq import ResidualVQ as JaxResidualVQ
    from test_torch_avocodo_train import _seeded, _wav
    from test_torch_avocodo_train import jax_tiny_trainer as jax_avocodo
    from test_torch_avocodo_train import port_tiny_trainer as port_avocodo
    from test_torch_shape_gain import RVQ, _draws as sg_draws
    from test_torch_train_step import jax_draws, port_tiny_trainer
    from test_train_step import tiny_trainer

    from hilcodec_tpu_torch.ops import shape_gain as TSG
    from hilcodec_tpu_torch.ops.rvq import ResidualVQ

    key = jax.random.PRNGKey(1)
    ref = {"key": key}

    jtr = tiny_trainer()
    flat, js = _seeded(jtr)
    wav = (np.random.default_rng(SEED + 1).standard_normal(
        (B, 1, jtr.model.hop_length * FRAMES)) * 0.3).astype(np.float32)
    flagship = dict(trainer=port_tiny_trainer(), flat=flat, wav=wav,
                    draws=jax_draws(jtr, js, key, B // 2 * FRAMES))
    ref["flagship"] = dict(jtr=jtr, js=js, wav=wav)

    jav = jax_avocodo()
    aflat, ajs = _seeded(jav)
    awav = np.concatenate([_wav(1), _wav(2)])
    avocodo = dict(trainer=port_avocodo(), flat=aflat, wav=awav,
                   draws=jax_draws(jav, ajs, key, B // 2 * (
                       awav.shape[-1] // jav.model.hop_length)))
    ref["avocodo"] = dict(jtr=jav, js=ajs, wav=awav)

    jsg = JSG.ResidualShapeGainVQ(**RVQ)
    sg_state = jsg.init_state(jax.random.PRNGKey(0))
    x = (np.random.default_rng(5).standard_normal((2, RVQ["dim"], SG_ROWS))
         * 2).astype(np.float32)
    shape_gain = dict(
        vq=TSG.ResidualShapeGainVQ(**RVQ),
        state={k: torch.from_numpy(np.asarray(v))
               for k, v in sg_state.items()},
        x=x, draws=sg_draws(key, jsg, SG_ROWS))
    ref["shape_gain"] = dict(vq=jsg, state=sg_state, x=x)

    kw = dict(dim=16, codebook_size=16, num_quantizers=2, kmeans_init=True,
              ema_num_initial=0.5)
    jvq = JaxResidualVQ(**kw)
    z = (np.random.default_rng(6).standard_normal((4, 16, 12))
         ).astype(np.float32)
    kkey = jax.random.PRNGKey(11)

    def init_idx(rows):
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.permutation(k, rows)[:16])
            for k in jax.random.split(kkey, 2)]).astype(np.int64))

    tvq = ResidualVQ(**kw)
    kmeans = dict(vq=tvq, state=tvq.init_state(torch.Generator()), z=z,
                  idx_full=init_idx(48), idx_half=init_idx(24))
    js0 = jvq.init_state(kkey)
    ref["kmeans"] = dict(
        full=jvq.kmeans_init_state(js0, jnp.asarray(z), kkey),
        rank0=jvq.kmeans_init_state(js0, jnp.asarray(z[:2]), kkey))

    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(dict(flagship=flagship, avocodo=avocodo,
                         shape_gain=shape_gain, kmeans=kmeans), f)
    return ref


def _write_loop_config(d):
    import yaml
    from test_torch_train_loop import cut_down, make_corpus
    corpus = os.path.join(d, "corpus")
    make_corpus(corpus)
    cfg = cut_down(corpus)
    # 4 items over 2 ranks at batch 1: two steps an epoch on each rank
    cfg["train"].update(batch_size=1, max_epochs=2)
    cfg["valid"] = {"batch_size": 1}
    with open(os.path.join(d, "loop.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)


def _shard_map(mesh, fn, out_specs):
    import jax
    from jax.sharding import PartitionSpec as P
    return jax.jit(jax.shard_map(fn, mesh=mesh,
                                 in_specs=(P(), P("dp"), P()),
                                 out_specs=out_specs, check_vma=False))


def _jax_references(ref):
    """JAX's data-parallel step on two CPU devices over the whole batch."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    key = ref["key"]
    stack = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731

    f = ref["flagship"]
    tr = dataclasses.replace(f["jtr"], axis_name="dp")
    step = _shard_map(mesh, lambda s, w, k: (
        stack(tr.compute_grads(s, w, k)), tr.train_step(s, w, k)),
        (P("dp"), P()))
    f["jaux"], (f["js_next"], f["jm"]) = step(f["js"],
                                              jnp.asarray(f["wav"]), key)

    a = ref["avocodo"]
    tr = dataclasses.replace(a["jtr"], axis_name="dp")
    a["jaux"] = _shard_map(mesh, lambda s, w, k: stack(
        tr.compute_grads(s, w, k)), P("dp"))(a["js"],
                                             jnp.asarray(a["wav"]), key)

    s = ref["shape_gain"]
    vq = s["vq"]
    s["out"] = jax.jit(jax.shard_map(
        lambda st, x, k: stack(vq(x, st, k, axis_name="dp")), mesh=mesh,
        in_specs=(P(), P("dp"), P()), out_specs=P("dp"),
        check_vma=False))(s["state"], jnp.asarray(s["x"]), key)
    return ref


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dp"))
    ref = _write_inputs(d)
    _write_loop_config(d)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--dir", d], cwd=d, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        ref = _jax_references(ref)
    finally:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
             for r in (0, 1)]
    return dict(d=d, ref=ref, ranks=ranks, logs=logs)


def _jax_shard(tree, r):
    import jax
    return jax.tree.map(lambda x: x[r], tree)


@pytest.mark.parametrize("rank", [0, 1])
def test_flagship_step_grads_match_jax_shard_map(pair, rank):
    """Each rank's losses, balancer EMA and VQ state, and the meaned G and
    D gradients, against JAX's shard `rank`."""
    from test_torch_train_step import _check_grads, _check_losses, _check_vq
    r = dict(jaux=_jax_shard(pair["ref"]["flagship"]["jaux"], rank),
             taux=pair["ranks"][rank]["flagship"]["taux"])
    _check_losses(r)
    _check_grads(r)
    _check_vq(r)


def test_flagship_train_step_matches_jax_and_ranks_agree(pair):
    """AdamP deltas of both sides and the meaned metrics against JAX's,
    and the two ranks' new states equal bit for bit."""
    from test_torch_train_step import _check_deltas
    f = pair["ref"]["flagship"]
    mine = pair["ranks"][0]["flagship"]
    _check_deltas(dict(js=f["js"], js_next=f["js_next"], ts=mine["ts"],
                       ts_next=mine["ts_next"], jm=f["jm"], tm=mine["tm"]))
    for k, v in f["jm"].items():
        if k != "num_replaces":
            np.testing.assert_allclose(float(mine["tm"][k]), float(v),
                                       rtol=1e-4, err_msg=k)
    a, b = (pair["ranks"][r]["flagship"]["flat_next"] for r in (0, 1))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
def test_avocodo_step_matches_jax_shard_map(pair, rank):
    from test_torch_train_step import LOSS_RTOL, _check_grads, _check_vq
    jaux = pair["ref"]["avocodo"]["jaux"]
    mine = pair["ranks"][rank]["avocodo"]
    r = dict(jaux=_jax_shard(jaux, rank), taux=mine["taux"])
    for k, v in r["jaux"]["losses"].items():
        np.testing.assert_allclose(float(mine["taux"]["losses"][k]),
                                   float(v), rtol=LOSS_RTOL, err_msg=k)
    _check_grads(r)
    _check_vq(r)
    # the metrics are the mean of the two shards' losses
    for k, v in jaux["losses"].items():
        np.testing.assert_allclose(float(mine["tm"][f"loss/{k}"]),
                                   float(np.mean(np.asarray(v))),
                                   rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
def test_shape_gain_pass_matches_jax_shard_map(pair, rank):
    q_j, st_j, loss_j, rep_j = _jax_shard(pair["ref"]["shape_gain"]["out"],
                                          rank)
    q_t, st_t, loss_t, rep_t = pair["ranks"][rank]["shape_gain"]
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for k in st_j:
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(rep_t.numpy(), np.asarray(rep_j))
    assert int(rep_t.sum()) > 0


def test_kmeans_init_on_gathered_batch_matches_jax(pair):
    """The loop's init: the batch gathered in rank order, k-means on all
    of it, equal to JAX's on the whole batch; kmeans_init_state with the
    group: rank 0's rows, as JAX's under its axis."""
    ref = pair["ref"]["kmeans"]
    z = np.asarray(_load(pair["d"], "inputs.pkl")["kmeans"]["z"])
    for r in (0, 1):
        mine = pair["ranks"][r]["kmeans"]
        np.testing.assert_array_equal(mine["gathered"].numpy(), z)
        for which in ("full", "rank0"):
            for k in ("embed", "ema_embed", "ema_num"):
                np.testing.assert_allclose(
                    mine[which][k].numpy(), np.asarray(ref[which][k]),
                    rtol=1e-4, atol=1e-5, err_msg=f"{which} {k}")


def test_process_mean_and_host_sums(pair):
    for r in (0, 1):
        assert pair["ranks"][r]["process_mean"] == pytest.approx(5 / 3)
        np.testing.assert_array_equal(pair["ranks"][r]["host_sums"],
                                      [1.0, 3.0])


def test_replica_check_raises_on_every_rank(pair):
    """A leaf that differs on rank 1 raises on both ranks, naming it."""
    for r in (0, 1):
        msg = pair["ranks"][r]["divergence"]
        assert msg is not None and "replica divergence at b.0" in msg


def test_two_epoch_loop_rank0_writes_and_every_rank_resumes(pair):
    run_dir = os.path.join(pair["d"], "run")
    ckpts = sorted(f for f in os.listdir(run_dir) if f.endswith(".npz"))
    assert ckpts == ["00001.ckpt.npz", "00002.ckpt.npz"]
    for sub in ("train", "valid"):
        assert any("tfevents" in f
                   for f in os.listdir(os.path.join(run_dir, sub)))
    l0, l1 = (pair["ranks"][r]["loop"] for r in (0, 1))
    assert (l0["writers"], l1["writers"]) == (4, 0)   # train + valid a run
    assert (l0["n_proc"], l0["shard"], l1["shard"]) == (2, (2, 0), (2, 1))
    assert l0["resumed_at"] == l1["resumed_at"] == 1
    assert l0["epoch"] == l1["epoch"] == 2
    for k in l0["state"]:
        np.testing.assert_array_equal(l0["state"][k], l1["state"][k],
                                      err_msg=k)


def test_world1_group_step_equals_the_step_without_a_group(tmp_path):
    """In process: a gloo group of one rank runs every collective of the
    step, and its state and metrics equal the step without a group bit
    for bit."""
    import torch.distributed as dist
    from test_torch_train_step import port_tiny_trainer

    from hilcodec_tpu_torch.parallel import dist as D
    from hilcodec_tpu_torch.utils import params as P

    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                world_size=1, rank=0)
    try:
        assert D.world() == 1
        plain = port_tiny_trainer()
        grouped = dataclasses.replace(plain, group=D.default_group())
        s0 = plain.init_state(torch.Generator().manual_seed(3))
        wav = torch.from_numpy((np.random.default_rng(4).standard_normal(
            (2, 1, 8 * FRAMES)) * 0.3).astype(np.float32))
        draws = plain.sample_draws(torch.Generator().manual_seed(5),
                                   wav.shape)
        a, ma = plain.train_step(s0, wav, draws)
        b, mb = grouped.train_step(s0, wav, draws)
        fa, fb = P.tree_to_flat(a), P.tree_to_flat(b)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
    finally:
        if own:
            dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ns = ap.parse_args()
    _rank_main(ns.rank, ns.dir)

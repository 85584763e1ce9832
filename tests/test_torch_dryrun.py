"""The port's dry runs and the data-parallel CLI: ``entry()`` against the
JAX ``__graft_entry__.entry()`` from converted parameters,
``dryrun_multidevice(2)`` on the CPU at a cut configuration, and one
torchrun ``cli train`` of two CPU ranks writing one metrics log."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

import torch_parity as tp
from deftet_tpu.config import TrainConfig as JaxConfig
from deftet_tpu.nn import DeformableTetNetwork as JaxNet
from deftet_tpu.nn import VertexAdjacency as JaxAdjacency
from deftet_tpu.train.statics import build_grid_statics as jax_statics
from deftet_tpu_torch import dryrun

ROOT = Path(__file__).resolve().parents[1]


def test_entry_matches_reference_entry():
    # __graft_entry__.entry()'s model, variables and inputs (its
    # model.init jitted: the same numbers, without eager dispatch)
    config = JaxConfig(res=20, n_point=2048, occ_sample=4096)
    statics = jax_statics(config.res)
    adj = JaxAdjacency(idx=statics.vert_adj_idx, mask=statics.vert_adj_mask,
                       degree=statics.vert_degree)
    model = JaxNet(adj=adj, blocks=config.parsed_blocks())
    rng = jax.random.PRNGKey(0)
    inp = jax.random.uniform(rng, (1, config.n_point, 3), minval=-0.5,
                             maxval=0.5)
    init_pos = statics.init_pos_nx3[None]
    centers = jax.random.uniform(rng, (1, config.occ_sample, 3), minval=-0.5,
                                 maxval=0.5)
    variables = jax.jit(lambda *a: model.init(*a, train=False))(
        rng, inp, init_pos, centers)
    ref = jax.jit(lambda v, *a: model.apply(v, *a, train=False))(
        variables, inp, init_pos, centers)

    fn, args = dryrun.entry(device="cpu", variables=tp.numpy_tree(variables))
    assert [tuple(a.shape) for a in args] == \
        [(1, 2048, 3), tuple(init_pos.shape), (1, 4096, 3)]
    got = fn(*(torch.tensor(np.asarray(a)) for a in
               (inp, init_pos, centers)))
    for name, g, r in zip(("delta", "pos", "ori", "logits"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # its own inputs: finite outputs of the reference's shapes
    own = fn(*args)
    assert [tuple(o.shape) for o in own] == [tuple(r.shape) for r in ref]
    assert all(torch.isfinite(o).all() for o in own)


def test_dryrun_multidevice_two_cpu_ranks(capsys):
    # the dry run's step at a cut configuration: res 4, the small network
    cfg = dryrun.dryrun_config(2, res=4, n_point=128, num_sample_points=128,
                               occ_sample=128, encoder_blocks="8,1,8;16,1,4",
                               gcn_hidden="16,8", pos_mlp_hidden="8",
                               occ_mlp_hidden="16,8")
    results = dryrun.dryrun_multidevice(2, device="cpu", config=cfg)
    assert len(results) == 2
    assert np.isfinite(results[0]["total"])
    assert results[0]["total"] == results[1]["total"]
    assert [r["backend"] for r in results] == ["gloo", "gloo"]
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multidevice(2): ok, backend=gloo")


def test_torchrun_cli_train_writes_one_log(tmp_path):
    # the verify recipe's tiny CPU run as two gloo ranks
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "deftet_tpu_torch.cli", "train",
           "--device", "cpu", "--res", "4", "--batch_size", "2",
           "--n_point", "128", "--num_sample_points", "256",
           "--occ_sample", "128", "--per_face_samples", "4",
           "--encoder_blocks", "8,1,8;16,1,4", "--gcn_hidden", "16,8",
           "--pos_mlp_hidden", "8", "--occ_mlp_hidden", "16,8",
           "--epochs", "1", "--n_shapes", "6",
           "--dataset_root", str(tmp_path / "data"),
           "--logdir", str(tmp_path / "exp"), "--eval_points", "256"]
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    runs = list((tmp_path / "exp").iterdir())
    assert len(runs) == 1, runs
    logs = list(tmp_path.rglob("metrics.jsonl"))
    assert logs == [runs[0] / "metrics.jsonl"]
    records = [json.loads(line) for line in logs[0].read_text().splitlines()]
    kinds = [r["kind"] for r in records]
    # one record per logged step and validation: written once, by rank 0
    assert kinds.count("val") == 1 and kinds.count("train") >= 1
    assert all(np.isfinite(r["total"]) for r in records if "total" in r)
    assert "2 ranks, gloo, 2 in the step" in out.stdout
    assert out.stdout.count("best occupancy IoU") == 1

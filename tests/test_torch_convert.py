"""flax variables -> the port's state dict: every leaf is consumed exactly
once, in the right layout, and anything left over or missing raises."""

import copy

import numpy as np
import pytest

import torch_parity as tp
from deftet_tpu.tetgrid import build_tet_grid as jax_grid
from deftet_tpu.train import statics as jax_statics
from deftet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from deftet_tpu_torch.nn import DeformableTetNetwork


@pytest.fixture(scope="module")
def flax_and_port():
    # dropout slots in both decoders: they own no parameters
    jcfg, cfg = tp.configs(pos_mlp_hidden="8,0.2,8",
                           occ_mlp_hidden="16,0.2,8")
    grid = jax_grid(jcfg.res)
    jstat = jax_statics.build_grid_statics(jcfg.res, grid=grid)
    variables = tp.numpy_tree(tp.jax_variables(tp.jax_model(jcfg, jstat),
                                               jcfg, jstat))
    port = DeformableTetNetwork(
        blocks=cfg.parsed_blocks(), gcn_hidden=cfg.parsed_gcn_hidden(),
        pos_mlp_hidden=cfg.parsed_pos_mlp_hidden(),
        occ_mlp_hidden=cfg.parsed_occ_mlp_hidden())
    return variables, port


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_every_leaf_consumed_once(flax_and_port):
    variables, port = flax_and_port
    state = flax_to_state_dict(variables, port)
    leaves = [p for c in ("params", "batch_stats")
              for p in _leaves(variables[c])]
    assert len(state) == len(leaves) == len(port.state_dict())
    load_flax_variables(port, variables)
    got = tp.flax_layout(port, port.state_dict())
    for c in ("params", "batch_stats"):
        for path, value in _leaves(variables[c]):
            np.testing.assert_array_equal(got[".".join(path)], value)


def test_conv_and_dense_layouts(flax_and_port):
    variables, port = flax_and_port
    state = flax_to_state_dict(variables, port)
    conv = variables["params"]["encoder_pos"]["PVConv_0"]["Conv_0"]["kernel"]
    w = state["encoder_pos.PVConv_0.Conv_0.weight"].numpy()
    # (k, k, k, in, out) -> (out, in, k, k, k): permuted, not flipped
    assert w.shape == (conv.shape[4], conv.shape[3]) + conv.shape[:3]
    assert w[1, 2, 0, 1, 2] == conv[0, 1, 2, 2, 1]
    dense = variables["params"]["decoder_occ"]["classifier"]["kernel"]
    np.testing.assert_array_equal(
        state["decoder_occ.classifier.weight"].numpy(), dense.T)


def test_unconsumed_leaf_raises(flax_and_port):
    variables, port = flax_and_port
    extra = copy.deepcopy(variables)
    extra["params"]["decoder_occ"]["Dense_9"] = {"kernel": np.zeros((8, 8))}
    with pytest.raises(ValueError, match="not consumed.*Dense_9"):
        flax_to_state_dict(extra, port)


def test_missing_leaf_raises(flax_and_port):
    variables, port = flax_and_port
    short = copy.deepcopy(variables)
    del short["batch_stats"]["decoder_pos"]["BatchNorm_0"]["var"]
    with pytest.raises(ValueError, match="no flax leaf.*running_var"):
        flax_to_state_dict(short, port)


def test_wrong_shape_raises(flax_and_port):
    variables, port = flax_and_port
    bad = copy.deepcopy(variables)
    bad["params"]["decoder_occ"]["classifier"]["bias"] = np.zeros(5)
    with pytest.raises(ValueError, match="does not fit"):
        flax_to_state_dict(bad, port)

"""The port's reference-checkpoint converters (``models/torch_export.py``,
``models/torch_import.py``) against the JAX package's: for the same
parameters the state_dicts agree key for key, in order, bit for bit; the
imports invert the exports; the saved ``.pth`` files load to equal
contents."""
import argparse
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu import models as jm
from neural_ode_metasolver_tpu_torch.models import (
    CifarConfig,
    build_model,
    cifar_params_from_jax,
    cifar_params_from_torch_state_dict,
    cifar_state_dict_from_params,
    metanode10,
    mnist_params_from_jax,
    mnist_params_from_torch_state_dict,
    mnist_state_dict_from_params,
    premetanode10,
    reference_wandb_config,
    save_cifar_reference_checkpoint,
    save_mnist_reference_checkpoint,
)

torch.set_num_threads(1)

CIFAR = [("premetanode10", "prebasic"), ("metanode10", "basic")]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mnist_pair(seed=0):
    """JAX init_mnist params (numpy leaves) and the port model holding
    them."""
    params = _np(jm.init_mnist(jax.random.key(seed), jm.MnistConfig(dim=16)))
    model = build_model("mnist", device="cpu", dim=16)
    model.load_state_dict(mnist_params_from_jax(params))
    return params, model


def _cifar_pair(name, seed=1):
    params, _ = jm.init_cifar(jax.random.key(seed),
                              jm.MODEL_REGISTRY[name](in_planes=16))
    params = _np(params)
    model = build_model(name, device="cpu", in_planes=16)
    model.load_state_dict(cifar_params_from_jax(params))
    return params, model


def _params(model):
    return OrderedDict((k, v) for k, v in model.state_dict().items()
                       if k.startswith("params."))


def _assert_sd_equal(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        g = np.asarray(got[k])
        r = np.asarray(ref[k])
        assert g.dtype == np.float32 and g.shape == r.shape, k
        np.testing.assert_array_equal(g, r, err_msg=k)


def _assert_params_equal(got, model):
    want = _params(model)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k


def test_mnist_state_dict_matches_jax_and_round_trips():
    params, model = _mnist_pair()
    sd = mnist_state_dict_from_params(model.detached_params())
    _assert_sd_equal(sd, jm.mnist_state_dict_from_params(params))
    assert all(isinstance(v, torch.Tensor) and v.is_contiguous()
               for v in sd.values())
    _assert_params_equal(mnist_params_from_torch_state_dict(sd), model)
    # the JAX import of the same state_dict carries to the same entries
    _assert_params_equal(mnist_params_from_jax(_np(
        jm.mnist_params_from_torch_state_dict(
            {k: v.numpy() for k, v in sd.items()}))), model)


@pytest.mark.parametrize("name,block_type", CIFAR)
def test_cifar_state_dict_matches_jax_and_round_trips(name, block_type):
    params, model = _cifar_pair(name)
    sd = cifar_state_dict_from_params(model.detached_params())
    _assert_sd_equal(sd, jm.cifar_state_dict_from_params(params))
    back = cifar_params_from_torch_state_dict(sd, block_type=block_type)
    _assert_params_equal(back, model)
    _assert_params_equal(cifar_params_from_jax(_np(
        jm.cifar_params_from_torch_state_dict(
            {k: v.numpy() for k, v in sd.items()},
            block_type=block_type))), model)
    # the imported entries load into a fresh model and export back to the
    # same state_dict, bit for bit
    fresh = build_model(name, device="cpu", in_planes=16,
                        generator=torch.Generator().manual_seed(5))
    fresh.load_state_dict(back)
    _assert_sd_equal(cifar_state_dict_from_params(fresh.detached_params()),
                     sd)


def test_exports_copy_the_weights():
    _, model = _mnist_pair()
    sd = mnist_state_dict_from_params(model.detached_params())
    sd["fc_layers.4.bias"].add_(1.0)
    assert not torch.equal(sd["fc_layers.4.bias"],
                           model.params["head"]["fc"]["bias"].detach())


def test_cifar_export_rejects_norm_bearing_trees():
    model = build_model("premetanode10", device="cpu", in_planes=8,
                        norms=("GN",) * 3)
    with pytest.raises(ValueError, match="norm-free"):
        cifar_state_dict_from_params(model.detached_params())


def test_mnist_export_rejects_multi_block_trees():
    _, model = _mnist_pair()
    params = model.detached_params()
    params = dict(params, blocks=params["blocks"] * 2)
    with pytest.raises(ValueError, match="exactly 1 ODE block"):
        mnist_state_dict_from_params(params)


def test_importers_refuse_what_they_do_not_map():
    params, model = _mnist_pair()
    sd = mnist_state_dict_from_params(model.detached_params())
    with pytest.raises(ValueError, match="does not map"):
        mnist_params_from_torch_state_dict(
            {**sd, "blocks.1.rhs_func.norm1.weight": sd["fc_layers.0.weight"]})
    missing = dict(sd)
    del missing["fc_layers.4.weight"]
    with pytest.raises(KeyError, match="fc_layers.4.weight"):
        mnist_params_from_torch_state_dict(missing)
    _, cmodel = _cifar_pair("premetanode10")
    csd = cifar_state_dict_from_params(cmodel.detached_params())
    with pytest.raises(ValueError, match="norm-bearing"):
        cifar_params_from_torch_state_dict(
            {**csd, "layer1.blocks_res.0.bn1.weight": torch.ones(16)})
    with pytest.raises(ValueError, match="multiple linear layers"):
        cifar_params_from_torch_state_dict(
            {**csd, "fc_layers.5.weight": csd["fc_layers.2.weight"]})
    with pytest.raises(ValueError, match="unknown block_type"):
        cifar_params_from_torch_state_dict(csd, block_type="wide")


@pytest.mark.parametrize("cfg,extra", [
    (premetanode10(in_planes=64, acts=("GeLUpoly",) * 3), {"seed": 7}),
    (metanode10(in_planes=32, norms=("GN", "NF", "BN"),
                param_norms=("SN", "PNF", "WN")), {}),
])
def test_reference_wandb_config_matches_jax(cfg, extra):
    jcfg = jm.MODEL_REGISTRY["premetanode10" if cfg.block_type == "prebasic"
                             else "metanode10"](
        in_planes=cfg.in_planes, norms=cfg.norms,
        param_norms=cfg.param_norms, acts=cfg.acts)
    wc = reference_wandb_config(cfg, **extra)
    assert wc == jm.reference_wandb_config(jcfg, **extra)
    assert list(wc) == list(jm.reference_wandb_config(jcfg, **extra))
    assert wc["activation_odeblock"] in ("GeLU", "ReLU")
    with pytest.raises(ValueError, match="no reference registry"):
        reference_wandb_config(CifarConfig(num_blocks=((3, 2),)))


def _load(path):
    return torch.load(path, weights_only=False)


def test_saved_mnist_checkpoint_matches_jax(tmp_path):
    params, model = _mnist_pair()
    args = {"solvers": [["rk2", "u", 8, -1, 0.5, -1]]}
    save_mnist_reference_checkpoint(str(tmp_path / "p.pth"),
                                    model.detached_params(), args=args,
                                    solver_id=2)
    jm.save_mnist_reference_checkpoint(str(tmp_path / "j.pth"), params,
                                       args=args, solver_id=2)
    got, ref = _load(tmp_path / "p.pth"), _load(tmp_path / "j.pth")
    assert list(got) == list(ref) == ["state_dict", "args", "solver_id"]
    _assert_sd_equal(got["state_dict"], ref["state_dict"])
    assert isinstance(got["args"], argparse.Namespace)
    assert vars(got["args"]) == vars(ref["args"])
    assert got["solver_id"] == ref["solver_id"] == 2
    model2 = build_model("mnist", device="cpu", dim=16,
                         generator=torch.Generator().manual_seed(3))
    model2.load_state_dict(mnist_params_from_torch_state_dict(
        got["state_dict"]))
    _assert_params_equal(_params(model2), model)


@pytest.mark.parametrize("name,block_type", CIFAR)
def test_saved_cifar_checkpoint_matches_jax(tmp_path, name, block_type):
    params, model = _cifar_pair(name)
    cfg = model.cfg
    jcfg = jm.MODEL_REGISTRY[name](in_planes=16)
    save_cifar_reference_checkpoint(str(tmp_path / "p.pth"),
                                    model.detached_params(), cfg, iter=11,
                                    wandb_config_extra={"lr": 0.1})
    jm.save_cifar_reference_checkpoint(str(tmp_path / "j.pth"), params,
                                       jcfg, iter=11,
                                       wandb_config_extra={"lr": 0.1})
    got, ref = _load(tmp_path / "p.pth"), _load(tmp_path / "j.pth")
    assert list(got) == list(ref) == ["model", "optimizer", "amp",
                                      "lr_scheduler", "iter", "wandb_config"]
    _assert_sd_equal(got["model"], ref["model"])
    assert got["wandb_config"] == ref["wandb_config"]
    assert (got["optimizer"], got["amp"], got["lr_scheduler"],
            got["iter"]) == (None, None, None, 11)
    _assert_params_equal(
        cifar_params_from_torch_state_dict(got["model"],
                                           block_type=block_type), model)

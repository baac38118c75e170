"""The port's reference-checkpoint interop (`interop.py`) against the JAX
package's, on the CPU in f32: a reference-named state_dict made by the JAX
`export_torch_state_dict` imports into the port (hg with sum, concat and
mobile blocks, and mspn), and the port's forward equals flax `apply` on
the same variables; the port's export equals the JAX export key for key
and bit for bit; arch detection, the strictness, the `module.` prefix and
the Trainer's payload; the import CLI, whose checkpoint resumes with the
learning-rate schedule fast-forwarded; the export CLI, whose file the JAX
importer reads back."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hourglass_pose_estimation_tpu import interop as jinterop
from hourglass_pose_estimation_tpu.models import MSPN as JaxMSPN
from hourglass_pose_estimation_tpu.models import HourglassNet as JaxNet

from hourglass_pose_estimation_torch import interop
from hourglass_pose_estimation_torch.config import load_config
from hourglass_pose_estimation_torch.models import get_model
from hourglass_pose_estimation_torch.models.norm import BatchNorm
from hourglass_pose_estimation_torch.runner import Trainer, checkpoint
from hourglass_pose_estimation_torch.runner.train_state import init_state, make_optimizer
from hourglass_pose_estimation_torch.weights import load_jax_variables, to_jax_variables

torch.set_num_threads(1)

ARCHS = {
    'hg-sum': ('hg', dict(num_stacks=2, num_classes=16, num_feats=16)),
    'hg-concat': ('hg', dict(num_stacks=1, num_classes=16, num_feats=16, skip_mode='concat')),
    'hg-mobile': ('hg', dict(num_stacks=1, num_classes=16, num_feats=16, mobile=True)),
    'mspn': ('mspn', dict(num_stacks=2, num_classes=16, out_res=16, up_channel_num=64)),
}
JAX_MODELS = {'hg': JaxNet, 'mspn': JaxMSPN}


def _variables(name, seed=0):
    """A JAX {'params', 'batch_stats'} tree of random values for the
    variant `name` (every leaf carries signal: BN affines and running
    statistics drawn too), and the flax model that reads it."""
    arch, kw = ARCHS[name]
    torch.manual_seed(seed)
    model = get_model(arch, device='cpu', dtype=torch.float32, **kw)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    jkw = {k: v for k, v in kw.items() if k != 'out_res' or arch == 'mspn'}
    return to_jax_variables(model), JAX_MODELS[arch](dtype=jnp.float32, **jkw)


def _cpu_model(name):
    arch, kw = ARCHS[name]
    return get_model(arch, device='cpu', dtype=torch.float32, **kw)


@pytest.mark.parametrize('name', sorted(ARCHS))
def test_import_of_jax_export_matches_flax(name):
    """JAX variables -> the JAX `export_torch_state_dict` (the reference's
    names, OIHW, num_batches_tracked) -> `convert_torch_state_dict` -> the
    port model: its eval forward equals flax `apply` on the variables
    (rtol 1e-3, atol 1e-4 of the largest value, as the port's model tests
    hold the hourglass), and its tensors equal the JAX tree's bit for
    bit."""
    variables, jmodel = _variables(name)
    ref_sd = {k: torch.from_numpy(np.array(v)) for k, v in
              jinterop.export_torch_state_dict(variables).items()}
    assert interop.detect_arch(ref_sd) == ARCHS[name][0]
    converted = interop.convert_torch_state_dict(ref_sd)
    assert not any(k.endswith('num_batches_tracked') for k in converted)
    model = _cpu_model(name)
    interop.check_tree_matches(model, converted)
    model.load_state_dict(converted)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(to_jax_variables(model)),
                            jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    x = np.random.RandomState(3).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize('name', sorted(ARCHS))
def test_export_equals_jax_export(name):
    """The port's export of a model equals the JAX export of its variables:
    the same keys in the reference's names, each tensor of the same dtype
    and shape (num_batches_tracked an int64 0-d 0) and the same bits."""
    variables, _ = _variables(name, seed=5)
    model = load_jax_variables(_cpu_model(name), variables)
    want = jinterop.export_torch_state_dict(variables)
    for got in (interop.export_torch_state_dict(model),
                interop.export_torch_state_dict(model.state_dict())):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            t = got[k].numpy()
            assert t.dtype == v.dtype and t.shape == v.shape, k
            np.testing.assert_array_equal(t, v, err_msg=k)
    # the export imports back to the same state_dict
    back = interop.convert_torch_state_dict(interop.export_torch_state_dict(model))
    assert back.keys() == model.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def test_detect_arch_and_strictness(tmp_path):
    """Arch detection, unknown and missing keys (listed in the error),
    DataParallel's `module.` prefix with the reference Trainer's payload
    {epoch, state_dict, optimizer, best_acc}, a bare state_dict, and a
    payload that `weights_only` refuses."""
    variables, _ = _variables('mspn')
    ref = {k: torch.from_numpy(np.array(v)) for k, v in
           jinterop.export_torch_state_dict(variables).items()}
    assert interop.detect_arch(ref) == 'mspn'
    assert interop.detect_arch({'module.hg.0.hg.0.0.0.bn1.weight': 0}) == 'hg'
    assert interop.detect_arch({'module.criterion.x': 0, 'top.conv.conv.weight': 0}) == 'mspn'
    with pytest.raises(interop.TorchImportError, match='cannot detect'):
        interop.detect_arch({'backbone.weight': 0})
    with pytest.raises(interop.TorchImportError, match='bogus'):
        interop.convert_torch_state_dict({**ref, 'mspn_modules.0.bogus.weight': torch.zeros(1)})
    with pytest.raises(interop.TorchImportError, match='unknown arch'):
        interop.convert_torch_state_dict(ref, arch='resnet')
    converted = interop.convert_torch_state_dict(ref)
    model = _cpu_model('mspn')
    missing = dict(converted)
    del missing['stage1.up4.res_conv2.bn.running_var']
    with pytest.raises(interop.TorchImportError, match='missing stage1.up4.res_conv2.bn.running_var'):
        interop.check_tree_matches(model, missing)
    with pytest.raises(interop.TorchImportError, match='unexpected stage0.top'):
        interop.check_tree_matches(model, {**converted, 'stage0.top.weight': torch.zeros(1)})
    with pytest.raises(interop.TorchImportError, match='1454 problems'):
        interop.check_tree_matches(_cpu_model('hg-sum'), converted)

    # the reference Trainer's payload, keys 'module.'-prefixed
    wrapped = {'module.' + k: v for k, v in ref.items()}
    path = tmp_path / 'checkpoint_7.pth.tar'
    torch.save({'epoch': 7, 'state_dict': wrapped, 'optimizer': {'state': {}, 'param_groups': []},
                'best_acc': 0.5625}, path)
    sd, meta = interop.load_torch_checkpoint(str(path))
    assert meta == {'epoch': 7, 'best_acc': 0.5625}
    assert sd.keys() == converted.keys()
    assert all(torch.equal(sd[k], v) for k, v in converted.items())
    bare = tmp_path / 'bare.pth'
    torch.save(ref, bare)
    sd, meta = interop.load_torch_checkpoint(str(bare))
    assert meta == {'epoch': 0, 'best_acc': 0.0} and sd.keys() == converted.keys()
    # a numpy best_acc: weights_only refuses it; trust_pickle reads it
    odd = tmp_path / 'numpy_best.pth.tar'
    torch.save({'epoch': 2, 'state_dict': ref, 'best_acc': np.float64(0.25)}, odd)
    with pytest.raises(pickle.UnpicklingError):
        interop.load_torch_checkpoint(str(odd))
    assert interop.load_torch_checkpoint(str(odd), trust_pickle=True)[1] == {
        'epoch': 2, 'best_acc': 0.25}


def _hg_reference(tmp, num_stacks=1):
    """A reference Trainer payload (keys 'module.'-prefixed) of the port's
    seeded hg (1 stack, 128 features, 16 joints) at epoch 3, and the model."""
    torch.manual_seed(11)
    model = get_model('hg', device='cpu', num_stacks=num_stacks, num_classes=16)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_var.uniform_(0.5, 1.5)
    src = tmp / 'best.pth.tar'
    torch.save({'epoch': 3, 'state_dict': {'module.' + k: v for k, v in
                                           interop.export_torch_state_dict(model).items()},
                'optimizer': {}, 'best_acc': 0.25}, src)
    return model, src


def _cfg_file(tmp, arch='hg', num_stacks=1):
    cfg = tmp / f'{arch}.yaml'
    width = '  up_channel_num: 64\n' if arch == 'mspn' else ''
    cfg.write_text('DATASET:\n  name: synthetic\n  inp_res: 64\n  out_res: 16\n'
                   f'  num_samples: 16\nMODEL:\n  arch: {arch}\n  num_stacks: {num_stacks}\n'
                   + width + 'TRAIN:\n  train_batch: 8\n  val_batch: 8\n  epochs: 5\n'
                   '  schedule: [2, 4]\n  precision: f32\n  learning_rate: 1.0e-3\n'
                   f'COMMON:\n  checkpoint_dir: {tmp}\n')
    return cfg


def test_import_cli_then_resume_fast_forwards_schedule(tmp_path, capsys):
    """`interop import` writes a port checkpoint with the payload's epoch and
    best_acc, step 0 and a fresh RMSprop; `COMMON.resume` of it restores the
    weights and fast-forwards the learning-rate schedule to epoch 3's step,
    past the decay at epoch 2 (as tests/test_torch_import.py holds the JAX
    Trainer). A config of another model is refused with the key diff."""
    model, src = _hg_reference(tmp_path)
    cfg = _cfg_file(tmp_path)
    out = tmp_path / 'imported'
    assert interop.main(['import', str(cfg), str(src), str(out), '--device', 'cpu']) == 0
    assert 'epoch=3 best_acc=0.2500' in capsys.readouterr().out
    saved = torch.load(out, weights_only=True)
    assert (saved['epoch'], saved['step'], saved['best_acc']) == (3, 0, 0.25)
    assert saved['optimizer']['state'] == {}
    want = model.state_dict()
    assert saved['model'].keys() == want.keys()
    assert all(torch.equal(saved['model'][k], v) for k, v in want.items())

    tr = Trainer(load_config(str(cfg), overrides=[f'COMMON.resume={out}']), verbose=False,
                 device='cpu')
    assert tr.steps_per_epoch == 2 and tr.start_epoch == 3
    assert tr.state.step == 3 * tr.steps_per_epoch
    assert tr.state.tx.lr(tr.state.step) == pytest.approx(1e-4)
    got = tr.state.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    with pytest.raises(interop.TorchImportError, match='missing hg1.low1_l1.block0.bn1.bias'):
        interop.main(['import', str(cfg), str(src), str(tmp_path / 'x'), 'MODEL.num_stacks=2',
                      '--device', 'cpu'])
    assert not (tmp_path / 'x').exists()


def test_export_cli_round_trip_mspn(tmp_path, capsys):
    """`interop export` of a port MSPN checkpoint writes the reference
    Trainer's payload, which the JAX importer reads back to the model's
    variables bit for bit; the port's import of it gives the same tensors."""
    variables, _ = _variables('mspn', seed=9)
    model = get_model('mspn', device='cpu', num_stacks=2, num_classes=16, out_res=16,
                      up_channel_num=64)
    load_jax_variables(model, variables)
    ckpt = tmp_path / 'checkpoint_4'
    checkpoint.save(str(ckpt), init_state(model, make_optimizer(1e-3, [], 0.1, 1)), 4, 0.5)
    out = tmp_path / 'mspn.pth.tar'
    assert interop.main(['export', str(ckpt), str(out)]) == 0
    assert f'{len(jinterop.export_torch_state_dict(variables))} state_dict entries' in \
        capsys.readouterr().out
    payload = torch.load(out, weights_only=True)
    assert (payload['epoch'], payload['best_acc'], payload['optimizer']) == (4, 0.5, {})
    jvars, meta = jinterop.load_torch_checkpoint(str(out))
    assert meta == {'epoch': 4, 'best_acc': 0.5}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jvars),
                            jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    cfg = load_config(str(_cfg_file(tmp_path, 'mspn', 2)))
    state, meta = interop.import_checkpoint(cfg, str(out), str(tmp_path / 'back'), device='cpu')
    assert meta == {'epoch': 4, 'best_acc': 0.5}
    want = model.state_dict()
    assert all(torch.equal(state.model.state_dict()[k], v) for k, v in want.items())

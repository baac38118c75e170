"""Reference (PyTorch) checkpoints to and from the port, for hg and mspn.

Port of `hourglass_pose_estimation_tpu/interop.py`. A user of the
reference project brings `.pth.tar` files written by its Trainer (payload
{epoch, state_dict, optimizer, best_acc}, state_dict keys optionally
'module.'-prefixed by DataParallel) or bare `state_dict`s. The port's
modules are named after the flax paths, so only names map: the port's
convolutions are OIHW like the reference's, and its BatchNorm leaves are
torch's (weight, bias, running_mean, running_var). `num_batches_tracked`
is dropped on import and synthesized (0) on export, so an export loads
with `strict=True` into the reference model.

Name tables (the reference's `src/models/hourglass.py`, `modules.py` and
`mspn.py`), the port's own copy:
  hg    Sequential indices -> explicit child names: `layer1.0.*` ->
        `layer1.*`, `hg.3.hg.2.1.0.*` -> `hg3.low1_l3.block0.*`,
        `fc.0.{0,1}` -> `fc0` + `fc_bn0`, trailing-underscore feedback
        convs `fc_`/`score_` -> `fc_back`/`score_back`, a bottleneck's
        `downsample.0` -> `downsample`;
  mspn  `top.conv.*` -> `top.*`, `mspn_modules.{i}` -> `stage{i}`, trunk
        `downsample.layer{L}.{b}.conv_bn_relu{1..3}` ->
        `downsample.layer{L}_block{b}.cbr{1..3}`, decoder
        `upsample.up{u}.<child>` -> `up{u}.<child>`; the embedded loss
        (`criterion.*`) has no parameters.
Every key must map: an unknown key raises TorchImportError (a silent drop
would corrupt an import), and so does a model the converted keys do not
fill exactly (`check_tree_matches`). The optimizer's accumulators are not
converted: an import resumes with a fresh RMSprop, and the Trainer
fast-forwards the learning-rate schedule to the checkpoint's epoch.

    python -m hourglass_pose_estimation_torch.interop import \\
        <config.yaml> <checkpoint.pth.tar> <out checkpoint> [SECTION.key=value ...]
    python -m hourglass_pose_estimation_torch.interop export \\
        <port checkpoint> <out.pth.tar>

`import` writes a port checkpoint (`runner/checkpoint.py`) that
`COMMON.resume` takes; `export` writes a reference-named `.pth.tar`.
Both read with `torch.load(weights_only=True)`. A reference payload that
pickles other objects than tensors, containers and numbers (a numpy
`best_acc`, say) does not load that way: `--trust-pickle` reads it with
`weights_only=False`, which runs the file's pickled code, so only for a
file one trusts.
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, Tuple

import torch

# reference Hourglass._make_hour_glass child index j -> role ([0] the up1
# skip branch, [1] low1 after the pool, [2] low3 in the decoder, [3] the
# extra chain at level 1)
_HG_CHILD = {0: 'up1', 1: 'low1', 2: 'low3', 3: 'low2'}
_INV_HG_CHILD = {v: k for k, v in _HG_CHILD.items()}
# reference MSPN ConvBNReLu children -> the port's ConvBN names
_MSPN_CBR = {'conv_bn_relu1': 'cbr1', 'conv_bn_relu2': 'cbr2',
             'conv_bn_relu3': 'cbr3', 'downsample': 'downsample'}
_INV_MSPN_CBR = {v: k for k, v in _MSPN_CBR.items()}
_MSPN_UNIT_CHILDREN = ('u_skip', 'up_conv', 'skip1', 'skip2', 'cross_conv',
                       'res_conv1', 'res_conv2')
_CONV_LEAVES = ('weight', 'bias')
_BN_LEAVES = _CONV_LEAVES + ('running_mean', 'running_var')
_HG_HEADS = ('conv1', 'bn1', 'layer1', 'layer2', 'layer3', 'hg', 'res', 'fc',
             'score', 'fc_', 'score_')
_MSPN_HEADS = ('top', 'mspn_modules', 'criterion')


class TorchImportError(ValueError):
    """A key or a tensor does not match the reference naming or the model."""


def _conv(path: Tuple[str, ...], leaf: str):
    if leaf not in _CONV_LEAVES:
        raise TorchImportError(f'unexpected conv leaf {leaf!r} at {path}')
    return path, leaf


def _bn(path: Tuple[str, ...], leaf: str):
    if leaf == 'num_batches_tracked':
        return None
    if leaf not in _BN_LEAVES:
        raise TorchImportError(f'unexpected BN leaf {leaf!r} at {path}')
    return path, leaf


def _bottleneck(path: Tuple[str, ...], rest):
    """Children of a reference hourglass bottleneck."""
    if rest[0] == 'downsample':
        # a Sequential of exactly one 1x1 conv
        if rest[1] != '0':
            raise TorchImportError(f'unexpected downsample child {rest}')
        return _conv(path + ('downsample',), rest[2])
    if rest[0] in ('bn1', 'bn2', 'bn3'):
        return _bn(path + (rest[0],), rest[1])
    if rest[0] in ('conv1', 'conv2', 'conv3'):
        return _conv(path + (rest[0],), rest[1])
    raise TorchImportError(f'unexpected bottleneck child {rest} at {path}')


def _map_key(key: str):
    """Reference hg key -> (the port's module path, leaf), or None for
    bookkeeping that is dropped (num_batches_tracked)."""
    parts = key.split('.')
    head = parts[0]
    try:
        if head == 'conv1':
            return _conv(('conv1',), parts[1])
        if head == 'bn1':
            return _bn(('bn1',), parts[1])
        if head in ('layer1', 'layer2', 'layer3'):
            # the stem layers are Sequentials of one block
            if parts[1] != '0':
                raise TorchImportError(f'stem {head} has unexpected block index {parts[1]}')
            return _bottleneck((head,), parts[2:])
        if head == 'hg':
            i = int(parts[1])
            if parts[2] == 'concat_conv':           # skip_mode='concat' merge
                return _conv((f'hg{i}', 'concat_conv'), parts[3])
            if parts[2] != 'hg':
                raise TorchImportError(f'unexpected hourglass child {parts[2]}')
            d, j, b = int(parts[3]), int(parts[4]), int(parts[5])
            return _bottleneck((f'hg{i}', f'{_HG_CHILD[j]}_l{d + 1}', f'block{b}'),
                               parts[6:])
        if head == 'res':
            i, b = int(parts[1]), int(parts[2])
            return _bottleneck((f'res{i}', f'block{b}'), parts[3:])
        if head == 'fc':
            i = int(parts[1])
            if parts[2] == '0':                     # Sequential(conv, bn, relu)
                return _conv((f'fc{i}',), parts[3])
            if parts[2] == '1':
                return _bn((f'fc_bn{i}',), parts[3])
            raise TorchImportError(f'unexpected fc child {parts[2]}')
        if head == 'score':
            return _conv((f'score{int(parts[1])}',), parts[2])
        if head == 'fc_':
            return _conv((f'fc_back{int(parts[1])}',), parts[2])
        if head == 'score_':
            return _conv((f'score_back{int(parts[1])}',), parts[2])
    except TorchImportError:
        raise
    except (IndexError, KeyError, ValueError) as e:
        raise TorchImportError(f'cannot map key {key!r}: {e}') from e
    raise TorchImportError(f"unrecognized state_dict key {key!r} for the reference 'hg' naming")


def _conv_bn(path: Tuple[str, ...], rest):
    """Children of a reference ConvBNReLu: the port's ConvBN keeps the
    names ('conv', 'bn')."""
    if rest[0] == 'conv':
        return _conv(path + ('conv',), rest[1])
    if rest[0] == 'bn':
        return _bn(path + ('bn',), rest[1])
    raise TorchImportError(f'unexpected ConvBNReLu child {rest} at {path}')


def _map_mspn_key(key: str):
    """Reference MSPN key -> (the port's module path, leaf) or None."""
    parts = key.split('.')
    try:
        if parts[0] == 'top':
            if parts[1] != 'conv':
                raise TorchImportError(f'unexpected InputLayer child {parts[1]}')
            return _conv_bn(('top',), parts[2:])
        if parts[0] == 'criterion':                 # embedded MSELoss
            return None
        if parts[0] == 'mspn_modules':
            i = int(parts[1])
            if parts[2] == 'downsample':
                layer, b = parts[3], int(parts[4])
                if layer not in ('layer1', 'layer2', 'layer3', 'layer4'):
                    raise TorchImportError(f'unexpected trunk layer {layer}')
                return _conv_bn((f'stage{i}', 'downsample', f'{layer}_block{b}',
                                 _MSPN_CBR[parts[5]]), parts[6:])
            if parts[2] == 'upsample':
                unit, child = parts[3], parts[4]
                if unit not in ('up1', 'up2', 'up3', 'up4'):
                    raise TorchImportError(f'unexpected decoder unit {unit}')
                if child not in _MSPN_UNIT_CHILDREN:
                    raise TorchImportError(f'unexpected unit child {child}')
                return _conv_bn((f'stage{i}', unit, child), parts[5:])
            raise TorchImportError(f'unexpected stage child {parts[2]}')
    except TorchImportError:
        raise
    except (IndexError, KeyError, ValueError) as e:
        raise TorchImportError(f'cannot map key {key!r}: {e}') from e
    raise TorchImportError(f"unrecognized state_dict key {key!r} for the reference 'mspn' naming")


def _strip(key: str) -> str:
    return key[len('module.'):] if key.startswith('module.') else key


def detect_arch(state_dict) -> str:
    """'hg' or 'mspn', from the reference key namespace of the first key
    that has one."""
    for key in state_dict:
        head = _strip(key).split('.')[0]
        if head in _MSPN_HEADS:
            return 'mspn'
        if head in _HG_HEADS:
            return 'hg'
    raise TorchImportError('cannot detect arch: no recognizable reference key namespace in '
                           f'{list(state_dict)[:5]}...')


def convert_torch_state_dict(state_dict, arch: str = 'auto') -> Dict[str, torch.Tensor]:
    """Reference state_dict -> the port's `state_dict` (f32 tensors on the
    CPU, the port's names). Takes torch tensors or numpy arrays, strips
    DataParallel's 'module.' prefix, detects the arch by default. Every key
    must map."""
    if arch == 'auto':
        arch = detect_arch(state_dict)
    if arch not in ('hg', 'mspn'):
        raise TorchImportError(f'unknown arch {arch!r}')
    mapper = _map_mspn_key if arch == 'mspn' else _map_key
    out = {}
    for key, val in state_dict.items():
        mapped = mapper(_strip(key))
        if mapped is None:
            continue
        path, leaf = mapped
        out['.'.join(path + (leaf,))] = torch.as_tensor(val).detach().to(
            'cpu', torch.float32).clone()
    return out


def check_tree_matches(model: torch.nn.Module, converted) -> None:
    """Raise TorchImportError listing every problem unless `converted` has
    exactly the keys and shapes of `model`'s state_dict."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in converted.items()}
    problems = [f'missing {k} {want[k]}' for k in sorted(set(want) - set(got))]
    problems += [f'unexpected {k} {got[k]}' for k in sorted(set(got) - set(want))]
    problems += [f'shape mismatch {k}: model {want[k]} vs checkpoint {got[k]}'
                 for k in sorted(set(want) & set(got)) if want[k] != got[k]]
    if problems:
        raise TorchImportError(f'converted checkpoint does not match the model '
                               f'({len(problems)} problems):\n  ' + '\n  '.join(problems[:40]))


def _torch_prefix_hg(path: Tuple[str, ...]) -> str:
    """The port's module path -> the reference key prefix, hg."""
    def bneck_child(rest):
        return 'downsample.0' if rest[0] == 'downsample' else rest[0]

    head = path[0]
    if head in ('conv1', 'bn1') and len(path) == 1:
        return head
    if head in ('layer1', 'layer2', 'layer3'):
        return f'{head}.0.{bneck_child(path[1:])}'
    m = re.fullmatch(r'(hg|res|fc_bn|fc_back|score_back|fc|score)(\d+)', head)
    if not m:
        raise TorchImportError(f'cannot invert hg path {path}')
    kind, i = m.group(1), int(m.group(2))
    if kind == 'hg':
        if path[1] == 'concat_conv':
            return f'hg.{i}.concat_conv'
        lm = re.fullmatch(r'(up1|low1|low2|low3)_l(\d+)', path[1])
        bm = re.fullmatch(r'block(\d+)', path[2])
        if not (lm and bm):
            raise TorchImportError(f'cannot invert hg path {path}')
        j, n, b = _INV_HG_CHILD[lm.group(1)], int(lm.group(2)), int(bm.group(1))
        return f'hg.{i}.hg.{n - 1}.{j}.{b}.{bneck_child(path[3:])}'
    if kind == 'res':
        return f'res.{i}.{int(path[1][len("block"):])}.{bneck_child(path[2:])}'
    return {'fc': f'fc.{i}.0', 'fc_bn': f'fc.{i}.1', 'score': f'score.{i}',
            'fc_back': f'fc_.{i}', 'score_back': f'score_.{i}'}[kind]


def _torch_prefix_mspn(path: Tuple[str, ...]) -> str:
    """The port's module path -> the reference key prefix, mspn (the
    trailing ConvBN child 'conv'/'bn' included)."""
    if path[0] == 'top':
        return f'top.conv.{path[1]}'
    m = re.fullmatch(r'stage(\d+)', path[0])
    if not m:
        raise TorchImportError(f'cannot invert mspn path {path}')
    i = int(m.group(1))
    if path[1] == 'downsample':
        lm = re.fullmatch(r'(layer\d)_block(\d+)', path[2])
        if not lm:
            raise TorchImportError(f'cannot invert mspn path {path}')
        return (f'mspn_modules.{i}.downsample.{lm.group(1)}.{int(lm.group(2))}.'
                f'{_INV_MSPN_CBR[path[3]]}.{path[4]}')
    if path[1] in ('up1', 'up2', 'up3', 'up4'):
        return f'mspn_modules.{i}.upsample.{path[1]}.{path[2]}.{path[3]}'
    raise TorchImportError(f'cannot invert mspn path {path}')


def export_torch_state_dict(state, arch: str = 'auto') -> Dict[str, torch.Tensor]:
    """A port model or its `state_dict` -> the reference-named state_dict
    (f32 CPU tensors, and an int64 0 `num_batches_tracked` per BatchNorm),
    the inverse of `convert_torch_state_dict`."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    if arch == 'auto':
        arch = 'mspn' if any(k.startswith('top.') for k in state) else 'hg'
    if arch not in ('hg', 'mspn'):
        raise TorchImportError(f'unknown arch {arch!r}')
    prefix_of = _torch_prefix_mspn if arch == 'mspn' else _torch_prefix_hg
    out, bn_prefixes = {}, []
    for key, val in state.items():
        *path, leaf = key.split('.')
        if leaf not in _BN_LEAVES:         # a conv's or a BatchNorm's
            raise TorchImportError(f'unexpected leaf {leaf!r} at {key}')
        prefix = prefix_of(tuple(path))
        out[f'{prefix}.{leaf}'] = val.detach().to('cpu', torch.float32).clone()
        if leaf == 'running_mean':
            bn_prefixes.append(prefix)
    for p in sorted(bn_prefixes):
        out[f'{p}.num_batches_tracked'] = torch.tensor(0, dtype=torch.int64)
    return out


def load_torch_checkpoint(path: str, trust_pickle: bool = False):
    """A reference `.pth.tar` (or a bare state_dict file) -> (the port's
    state_dict, {'epoch', 'best_acc'}; 0 / 0.0 for a bare state_dict).
    The payload's optimizer is not read. trust_pickle: see the module's
    docstring."""
    payload = torch.load(path, map_location='cpu', weights_only=not trust_pickle)
    meta = {'epoch': 0, 'best_acc': 0.0}
    if isinstance(payload, dict) and 'state_dict' in payload:
        meta['epoch'] = int(payload.get('epoch', 0) or 0)
        best = payload.get('best_acc', 0.0)
        meta['best_acc'] = float(best) if best is not None else 0.0
        payload = payload['state_dict']
    return convert_torch_state_dict(payload), meta


def import_checkpoint(cfg, src: str, out: str, device='cuda', trust_pickle: bool = False):
    """Convert the reference checkpoint `src` into a port checkpoint `out`
    for the model `cfg` describes: the payload's epoch and best_acc, step
    0 and a fresh RMSprop. -> (the TrainState, meta)."""
    from hourglass_pose_estimation_torch._device import resolve_device
    from hourglass_pose_estimation_torch.data import resolve_num_classes
    from hourglass_pose_estimation_torch.models import model_from_config
    from hourglass_pose_estimation_torch.runner import checkpoint
    from hourglass_pose_estimation_torch.runner.train_state import init_state, make_optimizer
    dev = resolve_device(device)
    converted, meta = load_torch_checkpoint(src, trust_pickle)
    model = model_from_config(cfg.model, num_classes=resolve_num_classes(cfg),
                              out_res=cfg.dataset.out_res, device=dev)
    check_tree_matches(model, converted)
    model.load_state_dict(converted)
    tc = cfg.train
    state = init_state(model, make_optimizer(tc.learning_rate, tc.schedule, tc.gamma, 1))
    checkpoint.save(out, state, epoch=meta['epoch'], best_acc=meta['best_acc'])
    return state, meta


def export_checkpoint(src: str, out: str) -> dict:
    """A port checkpoint (`runner/checkpoint.py`) -> the reference Trainer's
    payload {epoch, state_dict, optimizer (empty), best_acc} at `out`."""
    payload = torch.load(src, map_location='cpu', weights_only=True)
    ref = {'epoch': int(payload['epoch']),
           'state_dict': export_torch_state_dict(payload['model']),
           'optimizer': {}, 'best_acc': float(payload['best_acc'])}
    torch.save(ref, out)
    return ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest='cmd', required=True)
    imp = sub.add_parser('import', help='reference .pth.tar -> port checkpoint')
    imp.add_argument('config', help='YAML config of the checkpoint\'s model')
    imp.add_argument('checkpoint', help='reference .pth.tar or state_dict file')
    imp.add_argument('out', help='port checkpoint to write')
    imp.add_argument('overrides', nargs='*', help='SECTION.key=value')
    imp.add_argument('--device', default='cuda',
                     help="'cuda' (default) or 'cpu'")
    imp.add_argument('--trust-pickle', action='store_true',
                     help='read a payload that weights_only=True refuses')
    exp = sub.add_parser('export', help='port checkpoint -> reference .pth.tar')
    exp.add_argument('checkpoint', help='port checkpoint')
    exp.add_argument('out', help='reference .pth.tar to write')
    args = ap.parse_args(argv)
    if args.cmd == 'import':
        from hourglass_pose_estimation_torch.config import load_config
        cfg = load_config(args.config, overrides=args.overrides)
        state, meta = import_checkpoint(cfg, args.checkpoint, args.out, args.device,
                                        args.trust_pickle)
        n = sum(p.numel() for p in state.model.parameters())
        print(f'imported {args.checkpoint} -> {args.out}: arch={cfg.model.arch} '
              f'stacks={cfg.model.num_stacks} params={n:,} epoch={meta["epoch"]} '
              f'best_acc={meta["best_acc"]:.4f} (optimizer accumulators reset)', flush=True)
    else:
        ref = export_checkpoint(args.checkpoint, args.out)
        print(f'exported {args.checkpoint} -> {args.out}: {len(ref["state_dict"])} '
              f'state_dict entries, epoch={ref["epoch"]} best_acc={ref["best_acc"]:.4f}',
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

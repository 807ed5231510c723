"""Yaml config factory (counterpart of
paddle_tpu/contrib/slim/core/config.py): instantiate pruners,
strategies and controllers by class name with cross-references between
sections, plus the `compressor:` block. PyYAML is imported by
load_config alone: a dict config, or strategies built in Python, need
no yaml.

Example:

    version: 1.0
    pruners:
        pruner_1:
            class: 'StructuredPruner'
            pruning_axis: 0
    strategies:
        prune_strategy:
            class: 'UniformPruneStrategy'
            pruner: 'pruner_1'
            start_epoch: 0
            target_ratio: 0.5
            pruned_params: '.*w0'
        distill_strategy:
            class: 'DistillationStrategy'
            distillers: ['l2_distiller']
    distillers:
        l2_distiller:
            class: 'L2Distiller'
            teacher_feature_map: 'teacher.fc_0.tmp_1'
            student_feature_map: 'fc_0.tmp_1'
            distillation_loss_weight: 1
    compressor:
        epoch: 2
        checkpoint_path: './ckpt/'
        strategies:
            - prune_strategy
            - distill_strategy
"""
from __future__ import annotations

import inspect

__all__ = ["ConfigFactory", "load_config"]

_SECTIONS = ("pruners", "quantizers", "distillers", "controllers",
             "strategies")


def _registry():
    """Class-name -> class over every slim plugin namespace."""
    from .. import prune, quantization, distillation, nas
    from . import strategy as core_strategy
    reg = {}
    for mod in (prune, quantization, distillation, nas, core_strategy):
        for name in dir(mod):
            obj = getattr(mod, name)
            if inspect.isclass(obj):
                reg[name] = obj
    return reg


def load_config(path):
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


class ConfigFactory:
    def __init__(self, config):
        self.instances = {}
        self.compressor = {}
        self.strategies = []
        cfg = load_config(config) if isinstance(config, str) else config
        reg = _registry()
        defs = {}
        for section in _SECTIONS:
            for name, attrs in (cfg.get(section) or {}).items():
                defs[name] = dict(attrs)
        # resolve in dependency order: an attr naming another instance
        # is replaced by that instance
        resolving = set()

        def build(name):
            if name in self.instances:
                return self.instances[name]
            if name in resolving:
                raise ValueError(f"config cycle at {name!r}")
            resolving.add(name)
            attrs = dict(defs[name])
            cls_name = attrs.pop("class")
            cls = reg[cls_name]
            sig = inspect.signature(cls.__init__)
            accepted = {p for p in sig.parameters if p != "self"}
            kwargs = {}
            for k, v in attrs.items():
                if k not in accepted:
                    continue
                if isinstance(v, str) and v in defs:
                    v = build(v)
                elif isinstance(v, list):
                    v = [build(x) if isinstance(x, str) and x in defs
                         else x for x in v]
                kwargs[k] = v
            self.instances[name] = cls(**kwargs)
            resolving.discard(name)
            return self.instances[name]

        comp = cfg.get("compressor") or {}
        self.compressor = dict(comp)
        for name in comp.get("strategies") or list(
                (cfg.get("strategies") or {})):
            self.strategies.append(build(name))

    def instance(self, name):
        return self.instances.get(name)

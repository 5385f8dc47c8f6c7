"""YAML experiment configuration of the PyTorch port.

Port of paddle3d_tpu/apis/config.py (YAML parsing, `_base_` merge and
recursive `_load_object`, config.py:55-155). It cannot reuse the JAX
module: importing anything under paddle3d_tpu runs that package's
__init__, which imports jax.

The `model:` section (its training `loss:` included), `optimizer:` and
`lr_scheduler:` are built. Datasets arrive with the runtime slice
(ROADMAP.md, queue 1, item 5).
"""
import codecs
import copy
import inspect
import logging
import os
from typing import Any, Dict

import torch
import yaml

from . import manager

logger = logging.getLogger(__name__)


class Config:
    """Parse a YAML configuration and build its model with torch modules,
    on the card unless the caller passes device="cpu" (there is no fallback
    to the CPU: without CUDA, building the model raises)."""

    def __init__(self, path: str, device="cuda"):
        if not os.path.exists(path):
            raise FileNotFoundError("Config file {} not found".format(path))
        if not (path.endswith("yml") or path.endswith("yaml")):
            raise RuntimeError("Config file should be yaml format")
        self.dic = self._parse_from_yaml(path)
        self.device = device

    # ------------------------------------------------------------------ YAML
    def _update_dic(self, dic: Dict, base_dic: Dict) -> Dict:
        """Merge dic onto base_dic (`_inherited_: false` opts out)."""
        base_dic = copy.deepcopy(base_dic)
        dic = copy.deepcopy(dic)
        if dic.get("_inherited_", True) is False:
            dic.pop("_inherited_")
            return dic
        for key, val in dic.items():
            if isinstance(val, dict) and key in base_dic and isinstance(
                    base_dic[key], dict):
                base_dic[key] = self._update_dic(val, base_dic[key])
            else:
                base_dic[key] = val
        return base_dic

    def _parse_from_yaml(self, path: str) -> Dict:
        with codecs.open(path, "r", "utf-8") as f:
            dic = yaml.load(f, Loader=yaml.FullLoader) or {}
        if "_base_" in dic:
            cfg_dir = os.path.dirname(path)
            base_path = os.path.join(cfg_dir, dic.pop("_base_"))
            dic = self._update_dic(dic, self._parse_from_yaml(base_path))
        return dic

    # ------------------------------------------------------- component build
    def _load_component(self, com_name: str):
        for com in manager.ALL_MANAGERS:
            if com_name in com:
                return com[com_name]
        raise RuntimeError(
            "The specified component ({}) was not found".format(com_name))

    @staticmethod
    def _is_meta_type(item: Any) -> bool:
        return isinstance(item, dict) and "type" in item

    def _load_object(self, obj: Dict):
        """Recursively instantiate a dict with a `type:` key."""
        dic = copy.deepcopy(obj)
        component = self._load_component(dic.pop("type"))
        params = {}
        for key, val in dic.items():
            if self._is_meta_type(val):
                params[key] = self._load_object(val)
            elif isinstance(val, list):
                params[key] = [
                    self._load_object(item) if self._is_meta_type(item) else
                    item for item in val
                ]
            else:
                params[key] = val
        try:
            return component(**params)
        except TypeError:
            # configs carry knobs with no equivalent here; retry with the
            # signature-filtered kwargs and warn about every dropped key
            target = component.__init__ if inspect.isclass(component) \
                else component
            sig = inspect.signature(target)
            if any(p.kind == inspect.Parameter.VAR_KEYWORD
                   for p in sig.parameters.values()):
                raise
            keep = {k: v for k, v in params.items() if k in sig.parameters}
            dropped = sorted(set(params) - set(keep))
            if not dropped:
                raise
            logger.warning(
                "%s: dropping config keys with no equivalent here: %s",
                getattr(component, "__name__", component), dropped)
            return component(**keep)

    # ------------------------------------------------------------ properties
    @property
    def model(self):
        """The model on `self.device`, in training mode as torch builds it;
        call `.eval()` before `test_forward`."""
        if not hasattr(self, "_model"):
            model_cfg = self.dic.get("model")
            if model_cfg is None:
                raise RuntimeError("No model specified in the configuration")
            self._model = self._load_object(model_cfg).to(self.device)
        return self._model

    def _schedule(self):
        if "lr_scheduler" not in self.dic:
            raise RuntimeError(
                "No lr_scheduler specified in the configuration")
        return self._load_object(copy.deepcopy(self.dic["lr_scheduler"]))

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        """The torch optimizer over `self.model`'s parameters, its gradient
        clip included; the schedule's base rate is its learning rate, as
        the JAX package injects the schedule (step it with
        `lr_scheduler`)."""
        if not hasattr(self, "_optimizer"):
            if "optimizer" not in self.dic:
                raise RuntimeError(
                    "No optimizer specified in the configuration")
            cfg = copy.deepcopy(self.dic["optimizer"])
            if "lr_scheduler" in self.dic and "learning_rate" not in cfg:
                cfg["learning_rate"] = self._schedule()
            self._optimizer = self._load_object(cfg)(self.model.parameters())
        return self._optimizer

    @property
    def lr_scheduler(self) -> torch.optim.lr_scheduler.LambdaLR:
        """The config's schedule over `self.optimizer`; step it once after
        each optimizer step (lr at update k = the schedule at k)."""
        if not hasattr(self, "_lr_scheduler"):
            self._lr_scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.optimizer, self._schedule().factor)
        return self._lr_scheduler

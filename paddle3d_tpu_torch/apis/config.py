"""YAML experiment configuration of the PyTorch port.

Port of paddle3d_tpu/apis/config.py: YAML parsing, the `_base_` merge,
recursive `_load_object`, `dic=`, the command-line overrides and every
property of the JAX Config. It cannot reuse the JAX module: importing
anything under paddle3d_tpu runs that package's __init__, which imports
jax.

The model goes to `device`; the optimizer is a torch optimizer over its
parameters and `lr_scheduler` a LambdaLR over that optimizer (the JAX
package builds optax transformations); the datasets are the port's.
"""
import codecs
import copy
import inspect
import logging
import os
from typing import Any, Dict, Optional

import torch
import yaml

from . import manager

logger = logging.getLogger(__name__)


class Config:
    """Parse a YAML configuration and build its model with torch modules,
    on the card unless the caller passes device="cpu" (there is no fallback
    to the CPU: without CUDA, building the model raises)."""

    def __init__(self,
                 path: str = None,
                 learning_rate: float = None,
                 batch_size: int = None,
                 iters: int = None,
                 epochs: int = None,
                 dic: Dict = None,
                 device="cuda"):
        if dic is not None:
            self.dic = copy.deepcopy(dic)
        else:
            if not path:
                raise ValueError("Either path or dic must be given")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    "Config file {} not found".format(path))
            if not (path.endswith("yml") or path.endswith("yaml")):
                raise RuntimeError("Config file should be yaml format")
            self.dic = self._parse_from_yaml(path)
        self.device = device
        self.update(learning_rate=learning_rate, batch_size=batch_size,
                    iters=iters, epochs=epochs)

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

    def update(self,
               learning_rate: float = None,
               batch_size: int = None,
               iters: int = None,
               epochs: int = None):
        """Command-line overrides (reference: config.py:123-141): iters
        drops epochs and epochs drops iters."""
        if learning_rate is not None:
            self.dic.setdefault("lr_scheduler", {})
            self.dic["lr_scheduler"]["learning_rate"] = learning_rate
        if batch_size is not None:
            self.dic["batch_size"] = batch_size
        if iters is not None:
            self.dic["iters"] = iters
            self.dic.pop("epochs", None)
        if epochs is not None:
            self.dic["epochs"] = epochs
            self.dic.pop("iters", None)

    # ------------------------------------------------------- component build
    def _load_component(self, com_name: str):
        # the reference's cross-suite names ($paddleseg.X / $paddledet.X)
        # resolve into the port's registries
        if com_name.startswith(("$paddleseg.", "$paddledet.")):
            com_name = com_name.split(".", 1)[1]
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
    def batch_size(self) -> int:
        return self.dic.get("batch_size", 1)

    @property
    def iters(self) -> Optional[int]:
        return self.dic.get("iters")

    @property
    def epochs(self) -> Optional[int]:
        return self.dic.get("epochs")

    @property
    def train_by_epoch(self) -> bool:
        return "epochs" in self.dic

    @property
    def train_dataset_config(self) -> Dict:
        return copy.deepcopy(self.dic.get("train_dataset", {}))

    @property
    def val_dataset_config(self) -> Dict:
        return copy.deepcopy(self.dic.get("val_dataset", {}))

    @property
    def train_dataset(self):
        """The port's dataset of `train_dataset:` (built anew each read),
        None without one."""
        cfg = self.train_dataset_config
        return self._load_object(cfg) if cfg else None

    @property
    def val_dataset(self):
        cfg = self.val_dataset_config
        return self._load_object(cfg) if cfg else None

    @property
    def amp_cfg(self) -> Dict:
        return copy.deepcopy(self.dic.get("amp_cfg", {}))

    @property
    def ema_cfg(self) -> Dict:
        return copy.deepcopy(self.dic.get("ema_cfg", {}))

    @property
    def export_cfg(self) -> Dict:
        return copy.deepcopy(self.dic.get("export", {}))

    @property
    def sync_bn(self) -> bool:
        """False; a config with `sync_bn: true` raises: SyncBN comes with
        the data-parallel runtime (ROADMAP.md, queue 1, item 5,
        parallel/mesh.py)."""
        if self.dic.get("sync_bn", False):
            raise NotImplementedError(
                "sync_bn needs the data-parallel runtime, not ported yet "
                "(ROADMAP.md, queue 1, item 5: parallel/mesh.py)")
        return False

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

    def to_dict(self) -> Dict:
        """The YAML dict with its objects built (model, datasets,
        optimizer) and the schedule folded into the optimizer, as the JAX
        Config gives it."""
        dic = copy.deepcopy(self.dic)
        dic.update({"batch_size": self.batch_size, "model": self.model})
        if "train_dataset" in dic:
            dic["train_dataset"] = self.train_dataset
        if "val_dataset" in dic:
            dic["val_dataset"] = self.val_dataset
        if "optimizer" in dic:
            dic["optimizer"] = self.optimizer
        dic.pop("lr_scheduler", None)
        if self.iters is not None:
            dic["iters"] = self.iters
        if self.epochs is not None:
            dic["epochs"] = self.epochs
        return dic

    def __str__(self):
        return yaml.dump(self.dic)

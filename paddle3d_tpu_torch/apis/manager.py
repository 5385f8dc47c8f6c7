"""Component registry of the PyTorch port.

Port of paddle3d_tpu/apis/manager.py. The port keeps registries of its own,
so that a torch `PointPillars` never collides with the nnx one, and so that
importing them pulls in no JAX.
"""
import inspect


class ComponentManager:
    """A name -> component registry with decorator-based registration.

    Example:
        MODELS = ComponentManager("models")

        @MODELS.add_component
        class PointPillars: ...

        model_cls = MODELS["PointPillars"]
    """

    def __init__(self, name: str):
        self._components_dict = {}
        self._name = name

    def __getitem__(self, item: str):
        if item not in self._components_dict:
            raise KeyError(
                "{} does not exist in registry {}. Available: {}".format(
                    item, self._name, sorted(self._components_dict)))
        return self._components_dict[item]

    def __contains__(self, item: str):
        return item in self._components_dict

    def add_component(self, component):
        """Register a class or function under its name (a decorator)."""
        if not (inspect.isclass(component) or inspect.isfunction(component)):
            raise TypeError(
                "Expect class/function type, but received {}".format(
                    type(component)))
        name = component.__name__
        if name in self._components_dict:
            raise KeyError("{} already exists in registry {}".format(
                name, self._name))
        self._components_dict[name] = component
        return component


# The registries the ported slice fills (the JAX package has 24; the rest
# arrive with the slices that need them).
BACKBONES = ComponentManager("backbones")
MIDDLE_ENCODERS = ComponentManager("middle_encoders")
MODELS = ComponentManager("models")
NECKS = ComponentManager("necks")
VOXEL_ENCODERS = ComponentManager("voxel_encoders")
VOXELIZERS = ComponentManager("voxelizers")
HEADS = ComponentManager("heads")
LOSSES = ComponentManager("losses")
OPTIMIZERS = ComponentManager("optimizers")
LR_SCHEDULERS = ComponentManager("lr_schedulers")
POINT_ENCODERS = ComponentManager("point_encoders")
POSITIONAL_ENCODING = ComponentManager("positional_encoding")
TRANSFORMS = ComponentManager("transforms")
DATASETS = ComponentManager("datasets")
TRANSFORMER_ENCODERS = ComponentManager("transformer_encoders")
TRANSFORMER_ENCODER_LAYERS = ComponentManager("transformer_encoder_layers")
ATTENTIONS = ComponentManager("attentions")
BBOX_ASSIGNERS = ComponentManager("bbox_assigners")
MATCH_COSTS = ComponentManager("match_costs")
TRANSFORMER_DECODER_LAYERS = ComponentManager("transformer_decoder_layers")
TRANSFORMER_DECODERS = ComponentManager("transformer_decoders")
TRANSFORMERS = ComponentManager("transformers")

ALL_MANAGERS = [
    BACKBONES, MIDDLE_ENCODERS, MODELS, NECKS, VOXEL_ENCODERS, VOXELIZERS,
    HEADS, LOSSES, OPTIMIZERS, LR_SCHEDULERS, POINT_ENCODERS,
    POSITIONAL_ENCODING, TRANSFORMS, DATASETS,
    TRANSFORMER_ENCODERS, TRANSFORMER_ENCODER_LAYERS, ATTENTIONS,
    BBOX_ASSIGNERS, MATCH_COSTS, TRANSFORMER_DECODER_LAYERS,
    TRANSFORMER_DECODERS, TRANSFORMERS
]

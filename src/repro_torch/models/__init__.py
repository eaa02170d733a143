"""The port's language model: config, layers, attention and the
``Transformer`` with its train step."""
from .config import INPUT_SHAPES, InputShape, ModelConfig
from .model import (TrainState, Transformer, make_train_step, tree_items,
                    tree_leaves, tree_unflatten)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "TrainState",
           "Transformer", "make_train_step", "tree_items", "tree_leaves",
           "tree_unflatten"]

"""The port's language model: config, layers, attention, the xLSTM
blocks and the ``Transformer`` with its train and serve steps."""
from .config import INPUT_SHAPES, InputShape, ModelConfig
from .model import (TrainState, Transformer, make_serve_step,
                    make_train_step, tree_items, tree_leaves, tree_unflatten)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "TrainState",
           "Transformer", "make_serve_step", "make_train_step", "tree_items",
           "tree_leaves", "tree_unflatten"]

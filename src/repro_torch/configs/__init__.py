from .base import ModelConfig, ShapeConfig, SHAPES, get_config, list_configs, register, shape_applicable

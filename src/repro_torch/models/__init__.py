from .model import Model

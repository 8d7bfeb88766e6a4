from .train import train as train_depth

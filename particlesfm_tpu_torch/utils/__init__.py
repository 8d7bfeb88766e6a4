from .config import Config, load_config, save_config
from .timer import StageTimer

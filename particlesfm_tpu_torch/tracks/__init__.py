from .engine import TrackerConfig, TrackerOutput, run_tracker
from .optimize import optimize_locations
from .store import TrackArrays, assemble_tracks, sample_inside_window

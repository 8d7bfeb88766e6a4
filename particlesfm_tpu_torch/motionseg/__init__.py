from .infer import cut_windows, segment_tracks

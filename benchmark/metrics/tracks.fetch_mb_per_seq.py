"""tracks.fetch_mb_per_seq: megabytes per completed sequence that the
tracker's assembly copies from the card to the host, from the program's
counter `tracks.fetch_bytes` (`tracks/store.py` `assemble_tracks`: the kept
rows of xy and mask, inside the `tracks.assemble` span; counted on CUDA
only). A program without the counter gives no reading."""

import bench_spans

LAYER = "tracks"
UNIT = "MB"
install = bench_spans.install


def read(ctx):
    n = bench_spans.count_per_seq(ctx, "tracks.fetch_bytes")
    return None if n is None else n / 1e6

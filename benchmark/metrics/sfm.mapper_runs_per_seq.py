"""sfm.mapper_runs_per_seq: mapper starts per completed sequence, from the
program's counter `sfm.mapper_runs` (`sfm/mapper.py`: +1 at each
`_run_global_mapper_once` and at each glomap retry's `_position_and_refine`;
so the multi-start, the retries, the complement and every manager model)."""

import bench_spans

LAYER = "SfM stage"
UNIT = "runs"
install = bench_spans.install


def read(ctx):
    return bench_spans.count_per_seq(ctx, "sfm.mapper_runs")

"""Worker process of the two-process sharded-BA test (test_torch_parallel.py):
joins a gloo group through a FileStore, runs `sharded_bundle_adjust` on a
mesh of local CPU shards and saves its result. Kept apart from the test
module so the spawned processes import torch only."""
import numpy as np
import torch
import torch.distributed as dist


def run_sharded_ba(rank, world, store_path, out_dir, local, problem):
    from particlesfm_tpu_torch.globalsfm.tracks3d import TrackObs
    from particlesfm_tpu_torch.parallel import make_mesh, sharded_bundle_adjust

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        p = {k: torch.from_numpy(v) for k, v in problem.items()}
        st = sharded_bundle_adjust(
            make_mesh(devices=["cpu"] * local), p["q"], p["t"], p["params"], p["X"],
            TrackObs(p["fidx"], p["uv"], p["mask"]), p["free"], p["pm"], max_iterations=5)
        np.savez(f"{out_dir}/rank{rank}.npz", q=st.q.numpy(), t=st.t.numpy(),
                 X=st.X.numpy(), cost=st.cost.numpy(), iters=st.iters)
    finally:
        dist.destroy_process_group()

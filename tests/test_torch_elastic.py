"""The port's elastic checkpoint restore and its production meshes, each in
a subprocess with a time limit of its own (a process group is
process-wide, and the main pytest process keeps none).

* the port of ``tests/test_elastic.py``'s
  ``test_elastic_restore_across_mesh_shapes``: 8 ``gloo`` ranks on the
  CPU (8 processes, an in-directory ``FileStore``) save a tree of
  ``DTensor``s from a (4, 2) mesh and restore it onto (2, 4), every leaf
  bit for bit, each rank's shard the slice of the whole array its
  placements name; a bfloat16 leaf comes back bfloat16 with
  ``shardings`` (the file's dtype) and at its like's dtype without, as
  the reference's ``restore`` does;
* ``make_production_mesh``'s shapes and axis names on the dry run's
  placeholder group of 256 and of 512 ranks.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(code: str, timeout: int, script: pathlib.Path):
    """Run ``code`` as the script ``script`` (a file: ``spawn`` re-imports
    its main module in each rank)."""
    script.write_text(textwrap.dedent(code))
    return subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=timeout, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 GLOO_SOCKET_IFNAME="lo"))


def test_elastic_restore_across_mesh_shapes(tmp_path):
    r = _run(f"""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import DeviceMesh

    CKPT, STORE = r"{tmp_path / 'ckpt'}", r"{tmp_path / 'store'}"

    def rank_main(rank):
        from repro_torch.sharding import partition
        from repro_torch.training import checkpoint
        dist.init_process_group("gloo", store=dist.FileStore(STORE, 8),
                                rank=rank, world_size=8)
        tree = {{"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
                 "b": torch.ones((8,), dtype=torch.float32),
                 "h": (torch.arange(16, dtype=torch.float32) / 3
                       ).to(torch.bfloat16).reshape(2, 8)}}
        specs = {{"w": ("data", "model"), "b": ("data",),
                  "h": (None, ("data", "model"))}}

        def shardings(shape):
            mesh = DeviceMesh("cpu", torch.arange(8).reshape(shape),
                              mesh_dim_names=("data", "model"))
            return {{k: partition.sharding(s, mesh)
                     for k, s in specs.items()}}

        sh_a = shardings((4, 2))
        placed = {{k: partition.place(t, sh_a[k]) for k, t in tree.items()}}
        checkpoint.save(CKPT, 11, placed)

        # 'failed pod': restore the same logical state onto a (2, 4) mesh
        sh_b = shardings((2, 4))
        like = {{k: torch.zeros_like(t) for k, t in tree.items()}}
        restored, step, _ = checkpoint.restore(CKPT, like, shardings=sh_b)
        assert step == 11
        for k, t in tree.items():
            got = restored[k]
            assert got.device_mesh.shape == (2, 4)
            assert got.dtype == t.dtype, (k, got.dtype)
            want = t[partition.local_slices(t.shape, sh_b[k])]
            assert torch.equal(got.to_local(), want), (rank, k)
            assert torch.equal(got.full_tensor(), t), (rank, k)
        # without shardings: whole arrays at the like's dtype
        like32 = {{k: torch.zeros(t.shape) for k, t in tree.items()}}
        plain, _, _ = checkpoint.restore(CKPT, like32)
        assert plain["h"].dtype == torch.float32
        assert torch.equal(plain["h"], tree["h"].float())
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.start_processes(rank_main, nprocs=8, start_method="spawn")
        print("ELASTIC_OK")
    """, timeout=240, script=tmp_path / "elastic.py")
    assert "ELASTIC_OK" in r.stdout, r.stdout + r.stderr


def test_production_mesh_shapes(tmp_path):
    for world in (256, 512):
        r = _run(f"""
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh, mesh_chips
        dryrun.placeholder_group({world})
        m1 = make_production_mesh(device="cpu")
        assert m1.shape == (16, 16) and mesh_chips(m1) == 256
        assert m1.mesh_dim_names == ("data", "model")
        if {world} == 512:
            m2 = make_production_mesh(multi_pod=True, device="cpu")
            assert m2.shape == (2, 16, 16) and mesh_chips(m2) == 512
            assert m2.mesh_dim_names == ("pod", "data", "model")
        else:
            try:
                make_production_mesh(multi_pod=True, device="cpu")
                raise AssertionError("a 512-rank mesh on 256 ranks")
            except ValueError as e:
                assert "needs 512 ranks but only 256" in str(e), e
        print("MESH_OK")
        """, timeout=120, script=tmp_path / f"mesh{world}.py")
        assert "MESH_OK" in r.stdout, r.stdout + r.stderr

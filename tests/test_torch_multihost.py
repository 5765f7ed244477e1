"""The port's multi-process layer (``parallel/multihost.py``) against the
JAX package, on the CPU.

- ``partition_corpus`` equals JAX's on JAX's cases and more;
- ``initialize_distributed`` is idempotent and raises without a coordinator
  or torchrun's environment; ``global_batch_mesh`` needs a process group;
- two real processes in one gloo group (this file run as a script is the
  worker), each with ``devices=[cpu]``, run the dense global step over
  ``tests/multihost_worker.py``'s 16 pairs of 32 px with all four metrics,
  the masked step on one small bucket, a spatial step on a global mesh
  (``n_space=2``), and ``sweep_corpus_ladders(multihost=True,
  with_sizes="device")`` over its eight 48 px images at [50, 85].  Both
  processes return the same results, bit for bit; they equal the
  single-process port (1e-6 relative; sizes exactly), and JAX's
  single-process steps on its 8 virtual devices (the dense step without
  Butteraugli, as JAX's own worker runs it, at 1e-5; the ladder at the
  port's tiers, sizes exactly);
- ``multihost=True`` with exact sizes raises JAX's ``ValueError``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from codec_eval_tpu_torch import parallel as tp  # noqa: E402
from codec_eval_tpu_torch.kernels import masked as tm  # noqa: E402
from codec_eval_tpu_torch.parallel import multihost as tmh  # noqa: E402

CPU = torch.device("cpu")
METRICS = ("psnr", "ssimulacra2", "dssim", "butteraugli")
QUALITIES = [50.0, 85.0]
LADDER_METRICS = ("ssimulacra2", "psnr")
MASKED_SHAPES = ((32, 32), (30, 28), (17, 29), (32, 20))
PROCESSES = 2


def synthetic_corpus(n=16, size=32):
    """``tests/multihost_worker.py``'s (refs, dists)."""
    rng = np.random.default_rng(99)
    refs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    dists = np.clip(
        refs.astype(np.int16) + rng.integers(-12, 13, refs.shape), 0, 255
    ).astype(np.uint8)
    return refs, dists


def ladder_corpus(n=8, size=48):
    """``tests/multihost_worker.py``'s ``_ladder_corpus``."""
    rng = np.random.default_rng(77)
    y, x = np.mgrid[0:size, 0:size]
    images = []
    for i in range(n):
        base = 120 + 60 * np.sin(x / (7.0 + i)) + 45 * np.cos(y / (5.0 + i))
        img = np.clip(
            np.stack([base, base * 0.9 + 10, base * 0.8 + 20], -1)
            + rng.normal(0, 5, (size, size, 3)),
            0,
            255,
        ).astype(np.uint8)
        images.append(img)
    return images


def masked_bucket():
    """Four mixed-size pairs padded to one 32 x 32 bucket, and their dims."""
    rng = np.random.default_rng(5)
    refs, dists = [], []
    for h, w in MASKED_SHAPES:
        ref = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        dist = np.clip(ref.astype(np.int16) + rng.integers(-9, 10, ref.shape), 0, 255)
        refs.append(tm.pad_to_bucket(ref, 32, 32))
        dists.append(tm.pad_to_bucket(dist.astype(np.uint8), 32, 32))
    return np.stack(refs), np.stack(dists), np.array(MASKED_SHAPES, np.int32)


def spatial_pairs():
    rng = np.random.default_rng(11)
    refs = rng.integers(0, 256, (4, 96, 24, 3)).astype(np.uint8)
    dists = np.clip(refs.astype(np.int16) + rng.integers(-7, 8, refs.shape), 0, 255)
    return refs, dists.astype(np.uint8)


def _host(per_pair: dict, aggregates: dict) -> dict:
    return {"per_pair": {k: v.cpu().numpy().tolist() for k, v in per_pair.items()},
            "means": {k: float(v) for k, v in aggregates.items()}}


def run_steps(mesh, spatial_mesh, pid: int, procs: int, multihost: bool) -> dict:
    """Every step of the scenario on ``mesh``: a global mesh in each worker,
    a one-device mesh for the single-process reference, whose spatial part
    (``spatial_mesh`` None) is the unsharded step."""
    refs, dists = synthetic_corpus()
    per = len(refs) // procs
    local = slice(pid * per, (pid + 1) * per)
    step = tp.sharded_score_fn(mesh)
    out = {"dense": _host(*step(tmh.host_local_batch_to_global(mesh, refs[local]),
                                tmh.host_local_batch_to_global(mesh, dists[local])))}
    # shard_batch of the whole batch keeps this process's slice: the same step.
    out["dense_shard_batch"] = _host(*step(tp.shard_batch(mesh, refs),
                                           tp.shard_batch(mesh, dists)))
    mrefs, mdists, hw = masked_bucket()
    out["masked"] = _host(*tp.sharded_masked_score_fn(mesh)(
        tp.shard_batch(mesh, mrefs), tp.shard_batch(mesh, mdists), tp.shard_batch(mesh, hw)))
    srefs, sdists = spatial_pairs()
    if spatial_mesh is None:
        out["spatial"] = _host(*step(tp.shard_batch(mesh, srefs), tp.shard_batch(mesh, sdists)))
    else:
        out["spatial"] = _host(*tp.sharded_score_fn(spatial_mesh, spatial=True)(
            tp.shard_batch(spatial_mesh, srefs, spatial=True),
            tp.shard_batch(spatial_mesh, sdists, spatial=True)))
    lad = tp.sweep_corpus_ladders(ladder_corpus(), QUALITIES, mesh=mesh, metrics=LADDER_METRICS,
                                  with_sizes="device", multihost=multihost)
    out["ladder"] = {"scores": {k: v.tolist() for k, v in lad.scores.items()},
                     "sizes": lad.sizes.tolist()}
    out["share"] = tmh.partition_corpus(list(range(len(refs))))
    return out


def worker(pid: int, procs: int, port: int, out_path: str) -> None:
    tmh.initialize_distributed(f"127.0.0.1:{port}", procs, pid)
    tmh.initialize_distributed(f"127.0.0.1:{port}", procs, pid)  # idempotent
    mesh = tmh.global_batch_mesh(devices=[CPU])
    assert (mesh.process_index, mesh.process_count, mesh.devices.shape) == (pid, procs, (1, 1))
    spatial_mesh = tmh.global_batch_mesh(n_space=2, devices=[CPU, CPU])
    out = run_steps(mesh, spatial_mesh, pid, procs, multihost=True)
    Path(out_path).write_text(json.dumps(out))
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs, as in its workers: the
    planes are small and the eager ops many, and when the suite runs
    several processes at once the ops' threads otherwise wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two workers' results, and the single-process port's."""
    tmp = tmp_path_factory.mktemp("multihost")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MASTER_", "WORLD_", "RANK"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"  # small planes: one intra-op thread per worker
    procs = [
        subprocess.Popen([sys.executable, __file__, str(pid), str(PROCESSES), str(port),
                          str(tmp / f"{pid}.json")],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(PROCESSES)
    ]
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\nstdout={out}\nstderr={err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = [json.loads((tmp / f"{pid}.json").read_text()) for pid in range(PROCESSES)]
    single = run_steps(tp.make_mesh(devices=[CPU]), None, 0, 1, multihost=False)
    return got, single


@pytest.mark.parametrize("part", ["dense", "dense_shard_batch", "masked", "spatial", "ladder"])
def test_processes_agree_bit_for_bit(runs, part):
    got, _ = runs
    assert got[0][part] == got[1][part]


@pytest.mark.parametrize("part", ["dense", "dense_shard_batch", "masked", "spatial"])
def test_global_steps_equal_the_single_process_port(runs, part):
    got, single = runs
    g, s = got[0][part], single[part]
    assert g["per_pair"].keys() == s["per_pair"].keys() == set(METRICS)
    n = 16 if part.startswith("dense") else 4
    for k in METRICS:
        assert len(g["per_pair"][k]) == n
        np.testing.assert_allclose(g["per_pair"][k], s["per_pair"][k], rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(g["means"][f"mean_{k}"], s["means"][f"mean_{k}"], rtol=1e-6)
    assert got[0]["share"] == list(range(0, 16, 2)) and got[1]["share"] == list(range(1, 16, 2))


def test_dense_global_step_equals_jax_single_process(runs):
    """JAX's worker leaves Butteraugli out to keep CI time down; so does
    this comparison (the port's Butteraugli is held above to the port)."""
    import jax

    from codec_eval_tpu.parallel.mesh import make_mesh, sharded_score_fn

    got, _ = runs
    refs, dists = synthetic_corpus()
    mesh = make_mesh(n_batch=8, n_space=1, devices=jax.devices()[:8])
    per_pair, aggregates = sharded_score_fn(mesh, butteraugli=False)(refs, dists)
    for k in ("psnr", "ssimulacra2", "dssim"):
        np.testing.assert_allclose(got[0]["dense"]["per_pair"][k], np.asarray(per_pair[k]),
                                   rtol=1e-5, atol=1e-5 if k == "dssim" else 0.0, err_msg=k)
        np.testing.assert_allclose(got[0]["dense"]["means"][f"mean_{k}"],
                                   float(aggregates[f"mean_{k}"]), rtol=1e-5,
                                   atol=1e-5 if k == "dssim" else 0.0)


def test_multihost_ladder_equals_single_process_port_and_jax(runs):
    from codec_eval_tpu.parallel import ladder_runner as jlr
    from codec_eval_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from test_torch_tpujpeg import TIERS

    import jax

    got, single = runs
    lad = got[0]["ladder"]
    assert lad["sizes"] == single["ladder"]["sizes"]
    for k in LADDER_METRICS:
        np.testing.assert_allclose(lad["scores"][k], single["ladder"]["scores"][k], rtol=1e-6)
    want = jlr.sweep_corpus_ladders(ladder_corpus(), QUALITIES,
                                    mesh=jax_make_mesh(n_batch=1, devices=jax.devices()[:1]),
                                    metrics=LADDER_METRICS, with_sizes="device",
                                    images_per_chunk=1)
    np.testing.assert_array_equal(np.array(lad["sizes"]), want.sizes)
    for k in LADDER_METRICS:
        np.testing.assert_allclose(lad["scores"][k], want.scores[k], err_msg=k, **TIERS[k])


# -- the pieces that need no second process ----------------------------------


@pytest.mark.parametrize("name", [
    "parallel.make_mesh", "parallel.shard_batch", "parallel.sharded_score_fn",
    "parallel.sweep_corpus_ladders", "parallel.multihost.initialize_distributed",
    "parallel.multihost.global_batch_mesh", "parallel.multihost.partition_corpus",
    "parallel.multihost.host_local_batch_to_global",
])
def test_signatures_are_jax_s(name):
    """JAX's parameters, in order and with their defaults, lead the port's;
    the port may add keywords after them (``global_batch_mesh``'s devices)."""
    import importlib
    import inspect

    def params(pkg):
        mod, fn = f"{pkg}.{name}".rsplit(".", 1)
        sig = inspect.signature(getattr(importlib.import_module(mod), fn))
        return [(p.name, p.default) for p in sig.parameters.values()]

    jax_params, port_params = params("codec_eval_tpu"), params("codec_eval_tpu_torch")
    assert port_params[: len(jax_params)] == jax_params


@pytest.mark.parametrize("n_items,procs", [(11, 3), (16, 2), (5, 8), (0, 2), (7, 1)])
def test_partition_corpus_equals_jax(n_items, procs):
    from codec_eval_tpu.parallel.multihost import partition_corpus

    items = list(range(n_items))
    shares = [tmh.partition_corpus(items, process_id=i, num_processes=procs)
              for i in range(procs)]
    assert shares == [partition_corpus(items, process_id=i, num_processes=procs)
                      for i in range(procs)]
    assert sorted(x for s in shares for x in s) == items
    # Without a process group this is process 0 of 1.
    assert tmh.partition_corpus(items) == items


def test_initialize_distributed_needs_a_coordinator(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK"):
        tmh.initialize_distributed()
    with pytest.raises(ValueError, match="together"):
        tmh.initialize_distributed("127.0.0.1:1", num_processes=2)
    with pytest.raises(RuntimeError, match="initialize_distributed first"):
        tmh.global_batch_mesh(devices=[CPU])


def test_initialize_distributed_is_idempotent_and_meshes_need_their_group(monkeypatch):
    import torch.distributed as dist

    port = _free_port()
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert not dist.is_initialized()
    try:
        tmh.initialize_distributed()  # torchrun's env://
        tmh.initialize_distributed()
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = tmh.global_batch_mesh(n_space=2, devices=[CPU, CPU])
        assert mesh.devices.shape == (1, 2) and mesh.process_count == 1
        with pytest.raises(ValueError, match="do not split over n_space=2"):
            tmh.global_batch_mesh(n_space=2, devices=[CPU] * 3)
        shards = tmh.host_local_batch_to_global(mesh, np.zeros((3, 4, 4, 3), np.uint8))
        assert [s.shape for s in shards] == [(3, 4, 4, 3)]
    finally:
        dist.destroy_process_group()
    # A global mesh whose group is gone is an error, never a quiet single process.
    lonely = tp.Mesh(mesh.devices, process_index=0, process_count=2)
    refs, dists = synthetic_corpus(n=2, size=16)
    step = tp.sharded_score_fn(lonely, dssim=False, butteraugli=False, ssimulacra2=False)
    with pytest.raises(RuntimeError, match="initialize_distributed first"):
        step(tp.shard_batch(lonely, refs), tp.shard_batch(lonely, dists))


def test_multihost_ladders_refuse_exact_sizes():
    images = ladder_corpus(n=2)
    with pytest.raises(ValueError, match="host entropy coding would run once per process"):
        tp.sweep_corpus_ladders(images, QUALITIES, mesh=tp.make_mesh(devices=[CPU]),
                                multihost=True)
    lonely = tp.Mesh(tp.make_mesh(devices=[CPU]).devices, process_index=0, process_count=2)
    with pytest.raises(ValueError, match="multihost=True"):
        tp.sweep_corpus_ladders(images, QUALITIES, mesh=lonely, with_sizes="device")


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

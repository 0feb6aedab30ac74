"""Where the time of a training step goes in the PyTorch port (CUDA card).

Builds configs/config_carpet_train.py's training step through
``nerftex_torch.render.train.build_step``, Train's own set-up (its Dataset
with the Proxy pixel sampler and prefetch thread, ParamNerf at full width,
Renderer, AlphaLoss, Adam), on a synthetic TFRecord written by
nerftex_torch.tools.synth (32 swatches of 64x64, seed 0) in place of the
Blender swatches, warms up, then:

  1. times ``--steps`` steps with synchronised host clocks: steps/s, and
     per step the host time spent waiting for the data pipeline (the next
     batch of ``train_dataset.take``), copying the batch to the card,
     dispatching the step (forward, backward, Adam) and waiting for the
     card to finish it;
  2. profiles ``--profile-steps`` steps with torch.profiler: the wall time,
     the summed device time of all kernels, the device busy time and idle
     share per step (1 - busy / wall), the kernel launches per step, and
     the kernels ranked by device time; ``--trace FILE`` also writes the
     Chrome trace.

Run from the repo root on a machine with a CUDA card:

    python3 scripts/profile_torch_train.py [--steps 50] [--profile-steps 5] [--top 20] \
        [--remat false|true|save_encodings] [--trace FILE]
"""

import argparse
import copy
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(tfr, remat):
    """(dataset, train step, state) of configs/config_carpet_train.py on the
    TFRecord ``tfr``, set up by Train's own ``build_step``, with
    remat_net_chunks set to ``remat``."""
    from configs.config_carpet_train import config as stock
    from nerftex_torch.render.train import TrainState, build_step
    from nerftex_torch.utils import rng

    cfg = copy.deepcopy(stock)
    cfg["train_dataset_config"]["data_loader_config"]["tfr_path"] = tfr
    rng.set_seed(cfg["seed"])
    state = TrainState()
    dataset, _, _, step = build_step(
        cfg["train_dataset_config"], cfg["model_config"], cfg["loss_config"], cfg["lrate"],
        cfg["lrate_decay"], dict(cfg["renderer_config"], remat_net_chunks=remat), "cuda", state)
    return dataset, step, state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--profile-steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--remat", default="false", choices=("false", "true", "save_encodings"))
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: needs a CUDA card")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import chip_smoke
    from nerftex_torch.tools.synth import make_synthetic_tfrecord
    from nerftex_torch.utils import jax_rng, rng

    torch.backends.cuda.matmul.allow_tf32 = False
    remat = {"false": False, "true": True}.get(args.remat, args.remat)
    with tempfile.TemporaryDirectory() as tmp:
        tfr = make_synthetic_tfrecord(os.path.join(tmp, "train.tfr"), n_images=32, size=64,
                                      seed=0)
        dataset, step, state = build(tfr, remat)
    n_total = args.warmup + args.steps + args.profile_steps
    batches = iter(dataset.take(n_total))
    base = rng.stream_key(rng.STREAM_PERTURB)
    s = 0

    def one_step(times=None):
        nonlocal s
        t0 = time.perf_counter()
        data = next(batches)
        t1 = time.perf_counter()
        batch = {k: torch.as_tensor(v).to("cuda", non_blocking=True) for k, v in data.items()}
        t2 = time.perf_counter()
        loss = step(batch, jax_rng.fold_in(base, s))
        state.step = s + 1
        t3 = time.perf_counter()
        if times is not None:
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for name, dt in (("data", t1 - t0), ("copy", t2 - t1), ("dispatch", t3 - t2),
                             ("device_wait", t4 - t3)):
                times[name] += dt
        s += 1
        return loss

    for _ in range(args.warmup):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # Free-running steps/s (the Train loop syncs only when it logs).
    t0 = time.perf_counter()
    for _ in range(args.steps // 2):
        loss = one_step()
    float(loss)
    free_rate = (args.steps // 2) / (time.perf_counter() - t0)
    # Synchronised steps: where the host time goes.
    times = dict.fromkeys(("data", "copy", "dispatch", "device_wait"), 0.0)
    t0 = time.perf_counter()
    n_sync = args.steps - args.steps // 2
    for _ in range(n_sync):
        one_step(times)
    sync_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.profile_steps):
            loss = one_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(a.self_device_time_total for a in kernels)
    n_launches = sum(a.count for a in kernels)
    by_name = {a.key: (a.count, a.self_device_time_total) for a in kernels}
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    n_prof = args.profile_steps
    summary = {
        "card": chip_smoke.card_line(), "remat_net_chunks": remat,
        "steps_per_s_free": free_rate, "steps_per_s_synced": n_sync / sync_wall,
        "ms_per_step_host": {k: v / n_sync * 1e3 for k, v in times.items()},
        "peak_gib": peak,
        "profiled": {"steps": n_prof, "wall_ms_per_step": wall / n_prof * 1e3,
                     "device_busy_ms_per_step": busy_us / 1e3 / n_prof,
                     "idle_share": 1 - busy_us / 1e6 / wall,
                     "launches_per_step": n_launches / n_prof},
    }
    print(f"card: {summary['card']}  config: configs/config_carpet_train.py (4 x 256 rays x 256 "
          f"samples, f32, IEEE matmuls)  remat_net_chunks: {remat}")
    print(f"steps/s: {free_rate:.2f} free-running, {n_sync / sync_wall:.2f} synchronised each "
          f"step; peak device memory {peak:.2f} GiB")
    print("host ms per synchronised step: " + ", ".join(
        f"{k} {v:.2f}" for k, v in summary["ms_per_step_host"].items()))
    p = summary["profiled"]
    print(f"profiled {n_prof} steps: wall {p['wall_ms_per_step']:.2f} ms/step, device busy "
          f"{p['device_busy_ms_per_step']:.2f} ms/step, idle share {p['idle_share']:.3f}, "
          f"{p['launches_per_step']:.0f} kernel launches/step")
    print(f"{'device ms/step':>14} {'share':>6} {'calls/step':>10}  kernel")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]:
        print(f"{t / 1e3 / n_prof:14.3f} {t / busy_us:6.3f} {n / n_prof:10.1f}  {name[:100]}")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

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

With ``--device-resident`` it builds configs/full_carpet_train_device.py's
step instead (bf16, save_encodings remat, net_chunk 16384, the dataset on
the card, ``steps_per_dispatch`` steps per dispatch, each dispatch the
replays of one captured CUDA graph) on 32 synthetic 64x64 swatches, and
reports per dispatch: steps/s, the host's ms launching the replays and
waiting for the card, and over ``--profile-steps`` dispatches of
PROFILE_REPLAYS replays each, the device busy time and idle share and the
kernel launches per step (``--steps`` and ``--profile-steps`` count
dispatches there).

With ``--config mip`` or ``mip_imp`` it builds
configs/demo_grass_mip_train.py's or demo_grass_mip_imp_train.py's
host-fed step (MipRenderer, IPE on n_pos 6; the _imp one with 256
importance posts) on 32 synthetic swatches with the dataset's five
parameters and the config's proxy box.

Run from the repo root on a machine with a CUDA card:

    python3 scripts/profile_torch_train.py [--steps 50] [--profile-steps 5] [--top 20] \
        [--remat false|true|save_encodings] [--trace FILE] [--device-resident] \
        [--config carpet|mip|mip_imp]
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
PROFILE_REPLAYS = 10  # graph replays per profiled dispatch (--device-resident)
# --config: (config module, the synthetic swatches' parameter split)
CONFIGS = {"carpet": ("config_carpet_train", (1, 6)),
           "mip": ("demo_grass_mip_train", (2, 3)),
           "mip_imp": ("demo_grass_mip_imp_train", (2, 3))}


def build(tfr, remat, device_resident=False, stock="config_carpet_train"):
    """(dataset, train step, state) of configs/<stock>.py (with
    device_resident: configs/full_carpet_train_device.py) on the TFRecord
    ``tfr``, set up by Train's own ``build_step``, with remat_net_chunks
    set to ``remat`` (device_resident: the config's own)."""
    import importlib

    from nerftex_torch.render.train import TrainState, build_step
    from nerftex_torch.utils import rng

    if device_resident:
        stock = "full_carpet_train_device"
    cfg = copy.deepcopy(importlib.import_module(f"configs.{stock}").config)
    cfg["train_dataset_config"]["data_loader_config"]["tfr_path"] = tfr
    if not device_resident:
        cfg["renderer_config"]["remat_net_chunks"] = remat
    rng.set_seed(cfg["seed"])
    state = TrainState()
    dataset, _, _, step = build_step(
        cfg["train_dataset_config"], cfg["model_config"], cfg["loss_config"], cfg["lrate"],
        cfg["lrate_decay"], cfg["renderer_config"], "cuda", state,
        flat_params=cfg.get("flat_params", False),
        steps_per_dispatch=cfg.get("steps_per_dispatch", 1))
    return dataset, step, state


def kernel_table(prof):
    """(busy us, launches, {name: (calls, us)}) of a profile's CUDA kernels."""
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(a.self_device_time_total for a in kernels), sum(a.count for a in kernels),
            {a.key: (a.count, a.self_device_time_total) for a in kernels})


def print_top(by_name, busy_us, per, top, unit):
    print(f"{'device ms/' + unit:>16} {'share':>6} {'calls/' + unit:>12}  kernel")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"{t / 1e3 / per:16.3f} {t / busy_us:6.3f} {n / per:12.1f}  {name[:100]}")


def profile_device_resident(args, card):
    """The device-resident step, one dispatch of steps_per_dispatch graph
    replays at a time (see the module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        from nerftex_torch.tools.synth import make_synthetic_tfrecord

        tfr = make_synthetic_tfrecord(os.path.join(tmp, "train.tfr"), n_images=32, size=64,
                                      seed=0)
        _, step, _ = build(tfr, None, device_resident=True)
    k = step.losses.shape[0]
    s = 0
    for _ in range(args.warmup):
        step.run(s, k)
        s += k
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def dispatch(times, replays=k):
        nonlocal s
        # run()'s body, split: the host's replay launches, then its wait.
        step.step.fill_(s)
        step.slot.zero_()
        t0 = time.perf_counter()
        for _ in range(replays):
            step.graph.replay()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        times["launch"] += t1 - t0
        times["device_wait"] += time.perf_counter() - t1
        s += replays

    times = dict.fromkeys(("launch", "device_wait"), 0.0)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        dispatch(times)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof_times = dict.fromkeys(("launch", "device_wait"), 0.0)
    # The profiler's post-processing takes minutes for a whole dispatch
    # (about 7,700 kernels a step): profile PROFILE_REPLAYS replays of each.
    replays = min(k, PROFILE_REPLAYS)
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for _ in range(args.profile_steps):
            dispatch(prof_times, replays)
        prof_wall = time.perf_counter() - t1
    busy_us, n_launches, by_name = kernel_table(prof)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    n_steps = args.profile_steps * replays
    summary = {
        "card": card, "config": "configs/full_carpet_train_device.py", "steps_per_dispatch": k,
        "steps_per_s": args.steps * k / wall, "s_per_dispatch": wall / args.steps,
        "host_ms_per_dispatch": {n: v / args.steps * 1e3 for n, v in times.items()},
        "peak_gib": peak,
        "profiled": {"dispatches": args.profile_steps, "replays_each": replays,
                     "steps": n_steps,
                     "wall_ms_per_step": prof_wall / n_steps * 1e3,
                     "device_busy_ms_per_step": busy_us / 1e3 / n_steps,
                     "idle_share": 1 - busy_us / 1e6 / prof_wall,
                     "launches_per_step": n_launches / n_steps},
    }
    print(f"card: {card}  config: configs/full_carpet_train_device.py (4 x 256 rays x 256 "
          f"samples, bf16, save_encodings, net_chunk 16384, {k} graph replays per dispatch)")
    print(f"steps/s: {summary['steps_per_s']:.2f}; {summary['s_per_dispatch']:.3f} s per "
          f"dispatch; host ms per dispatch: " + ", ".join(
              f"{n} {v:.2f}" for n, v in summary["host_ms_per_dispatch"].items())
          + f"; peak device memory {peak:.2f} GiB")
    p = summary["profiled"]
    print(f"profiled {args.profile_steps} dispatches of {replays} replays ({n_steps} steps): wall "
          f"{p['wall_ms_per_step']:.2f} ms/step, device busy {p['device_busy_ms_per_step']:.2f} "
          f"ms/step, idle share {p['idle_share']:.4f}, {p['launches_per_step']:.0f} kernel "
          f"launches/step")
    print_top(by_name, busy_us, n_steps, args.top, "step")
    print(json.dumps(summary))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--profile-steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--remat", default="false", choices=("false", "true", "save_encodings"))
    ap.add_argument("--trace", default=None)
    ap.add_argument("--device-resident", action="store_true")
    ap.add_argument("--config", default="carpet", choices=tuple(CONFIGS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: needs a CUDA card")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import chip_smoke

    if args.device_resident:
        torch.backends.cuda.matmul.allow_tf32 = False
        profile_device_resident(args, chip_smoke.card_line())
        return
    from nerftex_torch.tools.synth import make_synthetic_tfrecord
    from nerftex_torch.utils import jax_rng, rng

    torch.backends.cuda.matmul.allow_tf32 = False
    remat = {"false": False, "true": True}.get(args.remat, args.remat)
    import importlib

    stock, n_parameters = CONFIGS[args.config]
    proxy = importlib.import_module(f"configs.{stock}").config["train_dataset_config"][
        "proxy_config"]
    with tempfile.TemporaryDirectory() as tmp:
        tfr = make_synthetic_tfrecord(os.path.join(tmp, "train.tfr"), n_images=32, size=64,
                                      seed=0, n_parameters=n_parameters,
                                      b_0=tuple(proxy["b_0"]), b_1=tuple(proxy["b_1"]))
        dataset, step, state = build(tfr, remat, stock=stock)
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
    busy_us, n_launches, by_name = kernel_table(prof)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    n_prof = args.profile_steps
    summary = {
        "card": chip_smoke.card_line(), "config": args.config, "remat_net_chunks": remat,
        "steps_per_s_free": free_rate, "steps_per_s_synced": n_sync / sync_wall,
        "ms_per_step_host": {k: v / n_sync * 1e3 for k, v in times.items()},
        "peak_gib": peak,
        "profiled": {"steps": n_prof, "wall_ms_per_step": wall / n_prof * 1e3,
                     "device_busy_ms_per_step": busy_us / 1e3 / n_prof,
                     "idle_share": 1 - busy_us / 1e6 / wall,
                     "launches_per_step": n_launches / n_prof},
    }
    print(f"card: {summary['card']}  config: configs/{stock}.py (4 x 256 rays, f32, IEEE "
          f"matmuls)  remat_net_chunks: {remat}")
    print(f"steps/s: {free_rate:.2f} free-running, {n_sync / sync_wall:.2f} synchronised each "
          f"step; peak device memory {peak:.2f} GiB")
    print("host ms per synchronised step: " + ", ".join(
        f"{k} {v:.2f}" for k, v in summary["ms_per_step_host"].items()))
    p = summary["profiled"]
    print(f"profiled {n_prof} steps: wall {p['wall_ms_per_step']:.2f} ms/step, device busy "
          f"{p['device_busy_ms_per_step']:.2f} ms/step, idle share {p['idle_share']:.3f}, "
          f"{p['launches_per_step']:.0f} kernel launches/step")
    print_top(by_name, busy_us, n_prof, args.top, "step")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

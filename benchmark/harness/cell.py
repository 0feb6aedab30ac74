"""One run of one cell: the mix's kind (benchmark/harness/<kind>.py) runs
the program, then its metrics, device record and checks become the
result line."""

import importlib
import sys

import torch

from benchmark.harness import manifest as mf


def find(name: str, root: str = mf.ROOT) -> dict:
    return mf.cell(mf.load(root), name)


def run(name, seed, seconds, trace, device, start, control=False, root=mf.ROOT) -> dict:
    """The result line of one run (see benchmark/run.py), as a dict;
    ``start`` is the process's start on the perf_counter clock."""
    manifest = mf.load(root)
    w = mf.cell(manifest, name)
    cfg = mf.config(manifest, w["config"], root)
    mix = mf.traffic(w["traffic"], root)
    # The configurations state float32 products: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = importlib.import_module(f"benchmark.harness.{mix['kind']}")
    stats, rec, attempted, failed, peak, checks, ready = kind.run(
        cfg, mix, mf.limits(name, root), seed, seconds, trace, device, root, control=control)
    metrics = {}
    if stats:
        print("window: " + ", ".join(f"{k} {v:.6g}" for k, v in stats.items()), file=sys.stderr)
    if not trace:
        for m in mf.end_to_end(manifest, name):
            value = ready - start if m["name"] == "setup_s" else stats[mix["metrics"][m["name"]]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in mf.per_layer(manifest, name):
            value = mf.reader(m["name"], root).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics, "device": info}
    if trace:
        info["busy_s"] = rec["part2"]["busy_s"]
        info["window_s"] = rec["part2"]["wall_s"]
        result["breakdown"] = {"device_ops": rec["part2"]["device_ops"],
                               "idle_gaps": rec["part2"]["idle_gaps"]}
    result["checks"] = checks
    return result

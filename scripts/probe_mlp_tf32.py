"""What bounds the wgmma_tf32x3 kernel: time variants of it, built from
nerftex_torch/kernels/csrc/mlp_fused.cu by text patches, at the bench
widths and weights (CUDA card).

  as_is        the kernel as committed (one slab of wgmmas in flight);
  pipelined    the previous slab's wgmmas left in flight (wait_group 1) while
               the next slab's fragments are split, as wgmma_bf16 does;
  no_stream    every slab copies the same 1 KB: the weights are garbage and
               the L2 traffic ~0, so its time is the kernel without its
               weight stream;
  one_product  a_hi w_hi alone: a third of the tensor work, the same
               traffic and synchronisation (single-pass TF32).

Each variant's ptxas report (registers, spills, wgmma serialisation), its
max |kernel - plain| (only as_is and pipelined compute the function) and
its device time (chip_smoke.device_ms) at 262,144 and 32,768 samples,
twice, in turns.  Prints one JSON line.

Run from the repo root on a machine with a CUDA card:

    python3 scripts/probe_mlp_tf32.py
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SLAB_END = """  wgmma_commit();
  fence_acc<N>(acc);
  wgmma_wait<0>();
  fence_acc<N>(acc);
  if (lane == 0) mbar_arrive(ring.bars + 8 * (T_STAGES + ring.it % T_STAGES));
  ++ring.it;
}
"""
_LAYER_END = """        tf32_slab<N>(acc, x, lbo, ring, lane, k);
      }
    }
  }
}
"""
_PRODUCTS = """    wgmma_tf32<N>(acc, lo[s], desc(b_hi, lbo, 8 * CORE_BYTES), k > 0);
    wgmma_tf32<N>(acc, hi[s], desc(b_lo, lbo, 8 * CORE_BYTES), 1);
    wgmma_tf32<N>(acc, hi[s], desc(b_hi, lbo, 8 * CORE_BYTES), 1);
"""
PATCHES = {
    "as_is": [],
    "pipelined": [
        (_SLAB_END, """  wgmma_commit();
  fence_acc<N>(acc);
  if (ring.holding) {
    wgmma_wait<1>();
    if (lane == 0) mbar_arrive(ring.bars + 8 * (T_STAGES + ring.held));
  }
  ring.held = ring.it % T_STAGES;
  ring.holding = true;
  ++ring.it;
}
"""),
        (_LAYER_END, _LAYER_END[:-2] + """  wgmma_wait<0>();
  fence_acc<N>(acc);
  if (ring.holding && lane == 0) mbar_arrive(ring.bars + 8 * (T_STAGES + ring.held));
  ring.holding = false;
}
"""),
    ],
    "no_stream": [("const uint32_t bytes = T_SLAB_K * L.n_pad * 8;", "const uint32_t bytes = 1024;"),
                  ("p.w + 2 * (L.w_off + (long long)k0 * L.n_pad), bytes", "p.w, bytes")],
    "one_product": [(_PRODUCTS, "    wgmma_tf32<N>(acc, hi[s], desc(b_hi, lbo, 8 * CORE_BYTES), k > 0);\n")],
}
SAMPLES = (262144, 32768)


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_mlp_tf32: needs a CUDA card")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import chip_smoke as cs
    from nerftex_torch.kernels import build, mlp_fused as fused
    from nerftex_torch.render.checkpoint import load_jax_params
    from nerftex_torch.utils.util import instantiate

    torch.backends.cuda.matmul.allow_tf32 = False
    base = open(os.path.join(build.CSRC, "mlp_fused.cu")).read()
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="probe-", dir=build.BUILD_DIR)
    procs = {}
    for name, reps in PATCHES.items():
        text = base
        for a, b in reps:
            if text.count(a) != 1:
                raise RuntimeError(f"{name}: the patch anchor is not in mlp_fused.cu once")
            text = text.replace(a, b)
        src = os.path.join(work, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build._BASE_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(work, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    result = {"card": cs.card_line(), "variants": {}}
    entries = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        i = out.find("Function properties for _Z15mlp_tf32_kernel")
        report = [line.strip() for line in out[i:].splitlines()[1:3]] if i >= 0 else []
        serialised = any("C7512" in line and "tf32" in line for line in out.splitlines())
        result["variants"][name] = {"ptxas": report, "wgmma_serialised": serialised}
        fn = ctypes.CDLL(os.path.join(work, f"{name}.so")).nt_mlp_fused
        fn.argtypes, fn.restype = build.ENTRIES["mlp_fused"][1], ctypes.c_int
        entries[name] = fn

    dev = torch.device("cuda")
    model = instantiate(cs.model_config("float32", compute_dtype="float32"), device="cuda")
    load_jax_params(model, cs.npz_params("torch_bench_inputs.npz"))
    packed = model.packed()
    for n in SAMPLES:
        rs = np.random.RandomState(1)
        pos = torch.tensor(rs.uniform(-1, 1, (n, 3)).astype(np.float32), device=dev)
        dirs = torch.nn.functional.normalize(
            torch.tensor(rs.normal(size=(n, 3)).astype(np.float32), device=dev), dim=-1)
        prm = torch.tensor(rs.uniform(0, 1, (n, model.n_geo + model.n_app)).astype(np.float32),
                           device=dev)
        with torch.no_grad():
            pos_map, dir_map = model.feature_maps(pos, dirs, prm)
        ref = fused.mlp_fused_plain(pos_map, dir_map, packed)
        pos_p = fused._pad_cast(pos_map, packed.pos_pad, torch.float32)
        dir_p = fused._pad_cast(dir_map, packed.dir_pad, torch.float32)
        out = torch.empty(n, 4, device=dev)

        def launcher(fn):
            def run():
                rc = fn(0, pos_p.data_ptr(), dir_p.data_ptr(), packed.pos_pad, packed.dir_pad,
                        packed.tf32_slabs.data_ptr(), packed.biases.data_ptr(),
                        packed.table.ctypes.data, len(packed.table), out.data_ptr(), n,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")
                return out
            return run

        for name, fn in entries.items():
            got = launcher(fn)()
            torch.cuda.synchronize()
            result["variants"][name][f"max_abs_err_{n}"] = float((got - ref).abs().max())
        for order in (list(entries), list(entries)[::-1]):
            for name in order:
                result["variants"][name].setdefault(f"device_ms_{n}", []).append(
                    cs.device_ms(launcher(entries[name]), iters=20))
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""K1's (or K2's) shared-memory tier, for comparing two checkouts.

Run from the root of each checkout on a machine with an NVIDIA GPU (the
parent unpacked into a git-ignored directory, this script given by path)::

    python3 /path/to/scripts/torch_k1_ab.py parent OUT   # in the parent
    python3 /path/to/scripts/torch_k1_ab.py change OUT   # in the change
    python3 scripts/torch_k1_ab.py --compare OUT/sass_parent.txt OUT/sass_change.txt
    python3 /path/to/scripts/torch_k1_ab.py parent OUT k2   # K2's
    python3 /path/to/scripts/torch_k1_ab.py parent2 OUT noptxas  # again
    python3 /path/to/scripts/torch_k1_ab.py parent OUT ric   # K6 / K7's
    python3 scripts/torch_k1_ab.py --compare-ric OUT/sass_parent_ric.json OUT/sass_change_ric.json
    python3 scripts/torch_k1_ab.py --compare-k2 OUT/sass_parent_k2.json OUT/sass_change_k2.json

The first form builds the checkout's kernel library, times the structured
IPM kernel (K1) in the tier its shape takes at P = 6, hp = hu = 20, V = 4,
B = 1,024, 7 iterations, seeded inputs, by CUDA-graph replay (10 launches
a graph, 5 replays; six readings), and at (l1)'s shape (parallel-11's
side-selection QP at hp = 20: 55 pairs, 66 single-block slabs, B = 1,280,
8 iterations) in its cluster tier and its device tier forced (3 launches a
graph, 3 replays; three readings each), prints one JSON line with the
``ptxas -v`` lines of K1's shared, device and cluster kernels (compiled
again from ``csrc/ipm_struct.cu``), and writes the opcodes of the SASS of
those three kernels (``cuobjdump -sass``) to ``OUT/sass_<name>.txt``
(shared), ``OUT/sass_<name>_device.txt`` and ``OUT/sass_<name>_cluster.txt``
(the kernels' mangled names differ between checkouts that template them
differently; the predicates of ``K1_TIERS`` find each); ``noptxas`` skips
the second compile (a repeated run of a checkout). With ``k2`` it times the dense-G kernel (K2) on
one frog QP (mg = 440, n = 21, 7 iterations) at B = 1,024 and 256 (the
launch bounds of four and two CTAs an SM that ``dense_min_ctas`` picks
there), writes the opcodes of its two shared-tier instantiations with
G in shared memory to ``OUT/sass_<name>_k2_<bound>.txt`` and those of
every instantiation of its shared, device and cluster tiers (and of the
out-of-line factor they call; ``K2_LABELS``, by template arguments, so that
checkouts that template them differently compare) to
``OUT/sass_<name>_k2.json`` with their ``ptxas -v`` lines, and the first
step of paths (f) (frog, hp = 20, B = 1,024), (i) (frog side selection,
hp = 10, B = 1,024) and (iii) (one frog scenario's side-selection step)
and a K2 launch in the cluster tier at (l3)'s shape (n = 257, B = 256,
seeded inputs) to ``OUT/steps_<name>_k2.pt``; ``--compare-k2`` compares
two such files as ``--compare-ric`` does. ``--compare``
prints the two opcode counts, their similarity ratio and the number of
differing blocks (``difflib``). With ``ric`` it times the Riccati
sweeps (K6 / K7) in their shared tier at V = 4 and V = 16 (B = 256, K =
64; the solve with one and two right-hand sides) and writes the opcodes
of every shared-tier instantiation (``riccati_factor_warp_kernel<V>``,
``riccati_factor_generic_kernel``, ``riccati_solve_kernel<V, NR>``) by
mangled name to ``OUT/sass_<name>_ric.json`` with their ``ptxas -v``
lines, and the first step of the long-horizon path (circle-4, hp = 64,
B = 256) and of the one-scenario banded step to ``OUT/steps_<name>.pt``;
``--compare-ric`` says, kernel by kernel, whether two such files hold the
same opcodes, and whether the steps are bit for bit the same. Run parent,
change, change, parent in one call.
"""
import difflib
import json
import os
import re
import subprocess
import sys

import torch


def graph_ms(fn, reps=10, replays=5):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * replays)


def sass_ops(lib, want) -> list:
    """The opcodes of the first SASS function of ``lib`` whose mangled name
    satisfies ``want``."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True).stdout
    mine = [f for f in sass.split("Function : ") if want(f.split("\n")[0])]
    return _ops_of(mine[0]) if mine else []


def _ops_of(function: str) -> list:
    """The opcodes of one function's ``cuobjdump -sass`` text."""
    ops = []
    for line in function.split("\n")[1:]:
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m:
            ops.append(m.group(2))
    return ops


def measure_k2(name: str, out_dir: str) -> None:
    sys.path.insert(0, os.getcwd())
    from scp_tpu_torch.ops import _cuda_build, ipm_kernel
    from scp_tpu_torch.testing import DENSE_ARG_ORDER, dense_kernel_inputs
    lib = _cuda_build.build_library()
    a = dense_kernel_inputs(1024, 440, 1, 20, seed=440)
    t = [None if a[k] is None else torch.as_tensor(a[k], device="cuda")
         for k in DENSE_ARG_ORDER]
    kw = dict(n_iters=7, tol=1e-6, reg_rel=3e-6, n_cor=0, schur_slack=True)
    rep = {"who": name, "kernel": "k2"}
    for B in (1024, 256):
        tb = [None if x is None else x[:B].contiguous() for x in t]
        rep[f"ms_B{B}"] = [
            graph_ms(lambda: ipm_kernel.ipm_iterate_dense(*tb, **kw))
            for _ in range(6)]
    for bound in (4, 2):
        ops = sass_ops(lib, lambda h, b=bound: "ipm_dense_kernel" in h
                       and f"ILb1ELi{b}E" in h and "cluster" not in h)
        with open(os.path.join(out_dir, f"sass_{name}_k2_{bound}.txt"),
                  "w") as f:
            f.write("\n".join(ops))
        rep[f"sass_instructions_{bound}"] = len(ops)
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True).stdout
    funcs = {}
    for f in sass.split("Function : ")[1:]:
        label = k2_label(f.split("\n")[0])
        if label:
            funcs[label] = _ops_of(f)
    with open(os.path.join(out_dir, f"sass_{name}_k2.json"), "w") as fh:
        json.dump(funcs, fh)
    rep["sass_kernels"] = {k: len(v) for k, v in funcs.items()}
    err = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", *_cuda_build.NVCC_FLAGS, "-Xptxas",
         "-v", "-c", "-o", os.devnull, str(_cuda_build.CSRC / "ipm_dense.cu")],
        capture_output=True, text=True).stderr.splitlines()
    rep["ptxas"] = {}
    for i, line in enumerate(err):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rep["ptxas"][k2_label(m.group(1)) or m.group(1)] = [
                x.split(":", 1)[-1].strip() for x in err[i + 1:i + 4]
                if "stack frame" in x or "registers" in x]
    torch.save(dense_steps(), os.path.join(out_dir, f"steps_{name}_k2.pt"))
    print(json.dumps(rep))


def k2_label(head: str):
    """The template arguments of a K2 function of the shared, device or
    cluster tier, or of the out-of-line factor they call, from its
    mangled name, as ``ipm_dense_kernel<kGSmem, kMinCtas, kKDev>`` /
    ``ipm_factor<kDevK>``; None for the global tier's (a fourth argument,
    or a second of the factor's, true) and for every other function."""
    m = re.search(r"ipm_dense_kernelILb([01])ELi([24])ELb([01])E"
                  r"(?:Lb([01])E)?E", head)
    if m:
        return None if m.group(4) == "1" else \
            f"ipm_dense_kernel<{m.group(1)}, {m.group(2)}, {m.group(3)}>"
    if "ipm_dense_cluster_kernel" in head:
        return "ipm_dense_cluster_kernel"
    m = re.search(r"ipm_factorILb([01])E(?:Lb([01])E)?E", head)
    if m:
        return None if m.group(2) == "1" else f"ipm_factor<{m.group(1)}>"
    return None


def dense_steps() -> dict:
    """The first step of paths (f), (i) and (iii) of ``chip_smoke.py``
    (frog under ``tuned_f32`` at hp = 20, B = 1,024 with TUNED_F32_PHASES;
    frog side selection at hp = 10, B = 1,024; one frog scenario's
    side-selection step through ``mpc_step``), seed 42, and one K2 launch
    at (l3)'s shape (mg = 384, n = 257, four 64 x 64 P blocks, B = 256, 7
    iterations: the cluster tier) on seeded inputs: their tensors, for a
    bitwise comparison of two checkouts."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.ops import ipm_kernel
    from scp_tpu_torch.scenarios import batch as batch_lib, builders
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.testing import DENSE_ARG_ORDER, dense_kernel_inputs
    out = {}

    def keep(tag, o):
        out.update({f"{tag}_{k}": v.cpu() for k, v in o._asdict().items()
                    if torch.is_tensor(v)})

    ss = dict(controller="side_selection")
    for tag, hp, over, extra in (
            ("f", 20, {}, {}),
            ("i", 10, ss, config_lib.TUNED_F32_SIDE_SELECTION)):
        gen = torch.Generator(device="cuda").manual_seed(42)
        cfg, data = batch_lib.make_batch("frog", 1024, generator=gen,
                                         dtype=torch.float32, device="cuda")
        cfg = config_lib.tuned_f32(cfg.replace(hp=hp, hu=hp, **over),
                                   **extra)
        keep(tag, engine.mpc_step_batch(
            cfg, data, engine.init_carry(cfg, data),
            phases=None if over else config_lib.TUNED_F32_PHASES)[1])
    cfg, data = builders.frog(dtype=torch.float32, device="cuda")
    cfg = config_lib.tuned_f32(cfg.replace(hp=10, hu=10, **ss),
                               **config_lib.TUNED_F32_SIDE_SELECTION)
    keep("iii", engine.mpc_step(cfg, data, engine.init_carry(cfg, data))[1])
    a = dense_kernel_inputs(256, 384, 4, 64, seed=384)
    t = [None if a[k] is None else torch.as_tensor(a[k], device="cuda")
         for k in DENSE_ARG_ORDER]
    res = ipm_kernel.ipm_iterate_dense(*t, n_iters=7, tol=1e-6, reg_rel=3e-6,
                                       n_cor=0, schur_slack=True)
    out.update({f"l3_{i}": r.cpu() for i, r in enumerate(res)})
    return out


# K1's shared, device and cluster kernels by mangled name: the shared
# tier's is untemplated in a parent without tiers, ``<false>`` with them and
# ``<false, false>`` once the global tier was added; the device tier's
# ``<true>`` / ``<true, false>`` (the global tier's ``<true, true>`` is left
# out); the cluster tier's untemplated
K1_TIERS = {
    "shared": lambda h: "ipm_struct_kernel" in h and "ILb1" not in h,
    "device": lambda h: ("ipm_struct_kernel" in h and "ILb1E" in h
                         and "ILb1ELb1E" not in h),
    "cluster": lambda h: "ipm_struct_cluster_kernel" in h,
}


def ptxas_lines(csrc) -> dict:
    """``ptxas -v``'s lines (stack frame and spills, registers) of K1's
    tiers in ``K1_TIERS``, from compiling ``csrc/ipm_struct.cu`` again."""
    from scp_tpu_torch.ops import _cuda_build
    err = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", *_cuda_build.NVCC_FLAGS, "-Xptxas",
         "-v", "-c", "-o", os.devnull, str(csrc / "ipm_struct.cu")],
        capture_output=True, text=True).stderr.splitlines()
    out = {}
    for i, line in enumerate(err):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if not m:
            continue
        tier = next((t for t, want in K1_TIERS.items() if want(m.group(1))),
                    None)
        if tier:
            out[tier] = [x.split(":", 1)[-1].strip() for x in err[i + 1:i + 4]
                         if "stack frame" in x or "registers" in x]
    return out


def measure(name: str, out_dir: str, ptxas: bool = True) -> None:
    sys.path.insert(0, os.getcwd())
    from scp_tpu_torch.ops import _cuda_build, ipm_kernel
    from scp_tpu_torch.testing import kernel_inputs, torch_kernel_args
    lib = _cuda_build.build_library()
    arrs, pairs, ov = kernel_inputs(B=1024, V=4, hp=20, hu=20, n_obst=0,
                                    seed=1)
    args = torch_kernel_args(arrs, device="cuda")
    kw = dict(pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6, n_cor=0,
              n_iters=7, lower_tri=True)
    rep = {"who": name,
           "ms": [graph_ms(lambda: ipm_kernel.ipm_iterate_struct(*args, **kw))
                  for _ in range(6)]}
    del args
    arrs, pairs, ov = kernel_inputs(B=1280, V=11, hp=20, hu=20, n_obst=6,
                                    seed=3, hard_rows=True)
    args = torch_kernel_args(arrs, device="cuda")
    kw = dict(pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6, n_cor=0,
              n_iters=8, lower_tri=True)
    for tier in ("cluster", "device"):
        rep[f"l1_{tier}_ms"] = [graph_ms(
            lambda: ipm_kernel.ipm_iterate_struct(*args, **kw, tier=tier),
            reps=3, replays=3) for _ in range(3)]
    for tier, want in K1_TIERS.items():
        ops = sass_ops(lib, want)
        tag = "" if tier == "shared" else f"_{tier}"
        with open(os.path.join(out_dir, f"sass_{name}{tag}.txt"), "w") as f:
            f.write("\n".join(ops))
        rep[f"sass_instructions_{tier}"] = len(ops)
    if ptxas:
        rep["ptxas"] = ptxas_lines(_cuda_build.CSRC)
    print(json.dumps(rep))


RIC_SHARED = ("riccati_factor_warp_kernel", "riccati_factor_generic_kernel",
              "riccati_solve_kernel")


def measure_ric(name: str, out_dir: str) -> None:
    sys.path.insert(0, os.getcwd())
    from scp_tpu_torch.ops import _cuda_build, riccati_kernel as rk
    from scp_tpu_torch.testing import riccati_inputs
    lib = _cuda_build.build_library()
    rep = {"who": name, "kernel": "k6k7_shared"}
    for V in (4, 16):
        t = {k: torch.as_tensor(v, device="cuda")
             for k, v in riccati_inputs(256, V, 64, seed=4).items()}
        t["a_blk"] = (0.9 * t["a_blk"]).contiguous()
        f_args = tuple(t[k] for k in ("a_blk", "b_blk", "hy", "hu"))
        fac = rk.riccati_factor(*f_args)
        r2 = torch.stack([t["r"], t["r"].flip(1)]).contiguous()
        s1 = (*fac, t["a_blk"], t["b_blk"], t["r"])
        s2 = (*fac, t["a_blk"], t["b_blk"], r2)
        for k, fn, args in (("factor", rk.riccati_factor, f_args),
                            ("solve_one", rk.riccati_solve, s1),
                            ("solve_two", rk.riccati_solve, s2)):
            rep[f"V{V}_{k}_ms"] = [graph_ms(lambda: fn(*args), reps=5,
                                            replays=3) for _ in range(3)]
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True).stdout
    funcs = {}
    for f in sass.split("Function : ")[1:]:
        head = f.split("\n")[0].strip()
        if any(k in head for k in RIC_SHARED):
            funcs[head] = _ops_of(f)
    with open(os.path.join(out_dir, f"sass_{name}_ric.json"), "w") as fh:
        json.dump(funcs, fh)
    rep["sass_kernels"] = {k: len(v) for k, v in funcs.items()}
    torch.save(banded_steps(), os.path.join(out_dir, f"steps_{name}.pt"))
    err = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", *_cuda_build.NVCC_FLAGS, "-Xptxas",
         "-v", "-c", "-o", os.devnull, str(_cuda_build.CSRC / "riccati.cu")],
        capture_output=True, text=True).stderr.splitlines()
    rep["ptxas"] = {}
    for i, line in enumerate(err):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m and any(k in m.group(1) for k in RIC_SHARED):
            rep["ptxas"][m.group(1)] = [
                x.split(":", 1)[-1].strip() for x in err[i + 1:i + 4]
                if "stack frame" in x or "registers" in x]
    print(json.dumps(rep))


def banded_steps() -> dict:
    """The first step of the long-horizon path (circle-4, hp = 64,
    B = 256, ``tuned_f32``: K6 / K7 through ``qp_kkt="auto"``) and of the
    one-scenario banded step (``qp_kkt="banded"``), seed 42: their
    StepOutputs' tensors, for a bitwise comparison of two checkouts."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.scenarios import batch as batch_lib, builders
    from scp_tpu_torch.sim import engine
    gen = torch.Generator(device="cuda").manual_seed(42)
    cfg, data = batch_lib.make_batch("circle", 256, generator=gen,
                                     dtype=torch.float32, device="cuda",
                                     n_veh=4)
    cfg = config_lib.tuned_f32(cfg.replace(hp=64, hu=64))
    _, out_d = engine.mpc_step_batch(cfg, data, engine.init_carry(cfg, data),
                                     phases=config_lib.TUNED_F32_PHASES)
    cfg1, data1 = builders.circle(4, dtype=torch.float32, device="cuda")
    cfg1 = config_lib.tuned_f32(cfg1.replace(hp=64, hu=64), qp_kkt="banded")
    _, out_e = engine.mpc_step(cfg1, data1, engine.init_carry(cfg1, data1))
    return {f"{p}_{k}": v.cpu() for p, o in (("d", out_d), ("e", out_e))
            for k, v in o._asdict().items() if torch.is_tensor(v)}


def _unhashed(name: str) -> str:
    """A mangled name without its anonymous namespace's per-build hash
    (``_GLOBAL__N__<hex>_<n>_riccati_cu_<hex>``)."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                  "_GLOBAL__N_", name)


def compare_ric(path_a: str, path_b: str) -> None:
    a, b = ({_unhashed(k): v for k, v in json.load(open(p)).items()}
            for p in (path_a, path_b))
    out = {"kernels": len(a), "same_names": sorted(a) == sorted(b),
           "identical": sum(1 for k in a if a[k] == b.get(k)),
           "differ": [k for k in a if a[k] != b.get(k)],
           "only_in_b": [k for k in b if k not in a]}
    steps = [p.replace("sass_", "steps_").replace("_ric.json", ".pt")
             .replace(".json", ".pt") for p in (path_a, path_b)]
    if all(os.path.exists(p) for p in steps):
        sa, sb = (torch.load(p) for p in steps)
        out["steps_bit_identical"] = {k: torch.equal(sa[k], sb[k])
                                      for k in sa}
    print(json.dumps(out))


def compare(path_a: str, path_b: str) -> None:
    a = open(path_a).read().split()
    b = open(path_b).read().split()
    sm = difflib.SequenceMatcher(None, a, b, autojunk=False)
    print("sass opcodes", len(a), len(b), "ratio", round(sm.ratio(), 5),
          "differing blocks",
          sum(1 for t in sm.get_opcodes() if t[0] != "equal"))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--compare"]:
        compare(*sys.argv[2:4])
    elif sys.argv[1:2] in (["--compare-ric"], ["--compare-k2"]):
        compare_ric(*sys.argv[2:4])
    elif not torch.cuda.is_available():
        sys.exit("no CUDA device")
    elif sys.argv[3:4] == ["k2"]:
        measure_k2(*sys.argv[1:3])
    elif sys.argv[3:4] == ["ric"]:
        measure_ric(*sys.argv[1:3])
    else:
        measure(*sys.argv[1:3], ptxas=sys.argv[3:4] != ["noptxas"])

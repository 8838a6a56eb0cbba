"""Same-seed velocity-SDE samples on the card: are two of them bit-equal, and
where do they part if not?

``chip_smoke.py`` phase 10b samples the trained release at 64³ b8 twice from
one seed (``sample_unconditional(method="sde")``, the first keeping its
trajectory) and requires equal decodes. This tool repeats that pair in one
process, after ``chip_smoke.py``'s phases 9 and 10a (``--after-phases app``) or after all of
its phases up to 10a, in its order (``--after-phases all``), in rounds:

* ``plain``: the pairs as phase 10b runs them, with the state's hash taken at
  each velocity evaluation (a forward pre-hook on the model);
* ``kernels``: ``plain`` with the outputs of K1 and K2 hashed too;
* ``modules``: each evaluation also hashes every module's input and output
  and the outputs of K1 and K2 (``ops.linear_attention.folded_context`` /
  ``folded_project``), in the order they complete;
* ``pressure``: the ``modules`` round while a buffer holds all but
  ``--margin-gib`` of the card's free memory;
* ``convs``: every 3-D convolution of the model, at the shapes a b8 64³
  forward gives it, twice on the same random input, then twice more under the
  buffer: whether ``F.conv3d`` itself returns the same bits.

* ``k1``: K1 alone at the flagship's 64³ stage (b8 × 262,144 tokens, 4 × 32
  bf16), ``--launches`` times on the same operands through the built library
  and through a variant built without the proxy fence of its consumer loop
  (``csrc/linear_attention.cu``, ``context_tiles``), in turns: how many
  launches return other bits than the first.

A round named ``name:nofence`` runs with the linear-attention library
replaced by that variant: K1 (and K4a) as they were before the fence.

For a pair that differs it prints the first evaluation whose state differs and
the first module (in completion order) whose output differs while its input
matched: the operation that parted them. A hash is the int64 sum of the
tensor's bits (its int16 / int32 view) beside its float64 sum.

    python -m flowtrain_stochastic_interpolation_torch.tools.sde_repro --after-phases app

It needs the card, the release weights (``artifacts/weights/uncond_demo_64``)
and ``chip_smoke.py`` at the repository's root.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import json
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.config import unconditional_64
from flowtrain_stochastic_interpolation_torch.inference import sample_unconditional
from flowtrain_stochastic_interpolation_torch.ops import cuda_build
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la

ROOT = Path(__file__).resolve().parents[2]
# the line of context_tiles that the "nofence" variant drops
K1_FENCE = "    fence_proxy_async();\n"
_INT_VIEW = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def smoke_module():
    """``chip_smoke.py`` of this checkout, imported by its path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def tensor_hash(t: torch.Tensor) -> torch.Tensor:
    """``[2]`` f64 on the device: the sum of the bits as integers, the sum of the values."""
    t = t.detach().contiguous().reshape(-1)
    bits = t.view(_INT_VIEW[t.element_size()]).sum(dtype=torch.int64).double()
    return torch.stack([bits, t.double().sum()])


class Recorder:
    """Hashes, in completion order, of the model's input state at each evaluation
    and (with ``modules``) of every module's input and output and K1's and K2's
    outputs. ``rows`` holds ``(evaluation, what, name)``; ``values`` the hashes."""

    def __init__(self, model: torch.nn.Module, modules: bool, kernels: bool):
        self.rows, self.values, self.evaluation = [], [], -1
        self.handles = [model.register_forward_pre_hook(self._state)]
        self.patched = []
        if modules:
            for name, module in model.named_modules():
                if module is model:
                    continue
                self.handles.append(module.register_forward_pre_hook(self._pre(name)))
                self.handles.append(module.register_forward_hook(self._post(name)))
        if modules or kernels:
            for kernel in ("folded_context", "folded_project"):
                self.patched.append((kernel, getattr(la, kernel)))
                setattr(la, kernel, self._spy(kernel, getattr(la, kernel)))

    def _add(self, what: str, name: str, t) -> None:
        if isinstance(t, torch.Tensor):
            self.rows.append((self.evaluation, what, name))
            self.values.append(tensor_hash(t))

    def _state(self, module, args):
        self.evaluation += 1
        self._add("state", "x", args[0])

    def _pre(self, name):
        return lambda module, args: self._add("in", name, args[0] if args else None)

    def _post(self, name):
        return lambda module, args, out: self._add("out", name, out)

    def _spy(self, kernel, fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            self._add("out", kernel, out)
            return out
        return recorded

    def close(self) -> np.ndarray:
        for handle in self.handles:
            handle.remove()
        for kernel, fn in self.patched:
            setattr(la, kernel, fn)
        return torch.stack(self.values).cpu().numpy() if self.values else np.zeros((0, 2))


def first_difference(rows, a: np.ndarray, b: np.ndarray):
    """The first evaluation whose state differs, and the first output (in
    completion order) that differs while the module's input matched."""
    differs = [i for i in range(len(rows)) if not np.array_equal(a[i], b[i])]
    if not differs:
        return None
    state = next((rows[i][0] for i in differs if rows[i][1] == "state"), None)
    inputs = {(rows[i][0], rows[i][2]): np.array_equal(a[i], b[i])
              for i in range(len(rows)) if rows[i][1] == "in"}
    for i in differs:
        evaluation, what, name = rows[i]
        if what == "out" and inputs.get((evaluation, name), True):
            return {"state_evaluation": state, "evaluation": evaluation, "operation": name,
                    "inputs_equal": inputs.get((evaluation, name))}
    evaluation, what, name = rows[differs[0]]
    return {"state_evaluation": state, "evaluation": evaluation, "operation": f"{what} {name}"}


def sde_pair(model, table, cfg, modules: bool, kernels: bool = False) -> dict:
    """Phase 10b's pair (the first keeping its trajectory), hashed."""
    ic = cfg.inference
    kw = dict(n_samples=8, batch_size=8, data_shape=cfg.data.shape,
              embedding_dim=cfg.data.embedding_dim, seed=100, device="cuda", verbose=False,
              t0=ic.t0, tf=ic.tf, n_frames=ic.n_frames, substeps=ic.substeps, method="sde",
              sde_epsilon=0.5, sde_eps_schedule="linear_decay", with_prominence=True)
    runs = []
    for keep in (True, False):
        recorder = Recorder(model, modules, kernels)
        try:
            result = sample_unconditional(model, table, keep_trajectory=keep, **kw)
        finally:
            values = recorder.close()
        runs.append((result, recorder.rows, values))
    (first, rows, a), (second, rows_b, b) = runs
    same = bool(np.array_equal(first.decoded, second.decoded))
    out = {"decodes_equal": same, "states_equal": bool(rows == rows_b and np.array_equal(a, b)),
           "seconds": [sum(first.seconds_per_batch), sum(second.seconds_per_batch)]}
    if rows == rows_b:
        out["first_difference"] = first_difference(rows, a, b)
    else:
        out["first_difference"] = "the two runs recorded other operations"
    return out


@contextlib.contextmanager
def pressure(margin_gib: float):
    """A buffer over all but ``margin_gib`` of the card's free memory."""
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    size = max(free - int(margin_gib * 2**30), 0)
    buf = torch.empty(size, dtype=torch.uint8, device="cuda")
    try:
        yield size
    finally:
        del buf
        torch.cuda.empty_cache()


def conv_shapes(model, cfg) -> list:
    """``(name, conv, input shape)`` of every 3-D conv of a b8 64³ forward."""
    seen, handles = [], []
    for name, module in model.named_modules():
        if isinstance(module, torch.nn.Module) and type(module).__name__ == "Conv3d":
            handles.append(module.register_forward_pre_hook(
                lambda m, args, name=name: seen.append((name, m, tuple(args[0].shape)))))
    x = torch.randn(8, *cfg.data.shape, cfg.data.embedding_dim, device="cuda")
    with torch.inference_mode():
        model(x, torch.full((8,), 0.5, device="cuda"))
    for handle in handles:
        handle.remove()
    return seen


def conv_round(model, cfg, margin_gib: float) -> list:
    found = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, conv, shape in conv_shapes(model, cfg):
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        with torch.inference_mode():
            outs = [tensor_hash(conv(x)).cpu().numpy() for _ in range(2)]
            with pressure(margin_gib):
                outs += [tensor_hash(conv(x)).cpu().numpy() for _ in range(2)]
        found.append({"conv": name, "input": shape,
                      "equal": [bool(np.array_equal(outs[0], o)) for o in outs[1:]]})
    return found


def phases_before_sde(cs, smi: str, which: str) -> None:
    """``chip_smoke.py``'s phases before 10b: 9 and 10a (``app``), or all of them
    from 2 on in its order (``all``)."""
    if which == "all":
        from flowtrain_stochastic_interpolation_torch.ops import flash_attention as fa
        from flowtrain_stochastic_interpolation_torch.ops import gemm_probes as gp
        from flowtrain_stochastic_interpolation_torch.ops import tap_conv as tc
        from flowtrain_stochastic_interpolation_torch.tools import ab_linear_attention
        from flowtrain_stochastic_interpolation_torch.tools import bench_folded

        cuda_build.load_all([la.SOURCE, fa.SOURCE, tc.SOURCE, gp.SOURCE])
        worst = cs.phase_kernel_check()
        cs.phase_kernel_times()
        ab_linear_attention.main()
        bench_folded.kernels(torch.device("cuda"))
        cs.phase_backwards()
        cs.phase_wide_heads(worst)
        cs.phase_tap_conv(worst)
        cs.phase_gemm_probes(worst)
        model, _ = cs.phase_sampling()
        cs.phase_conditional()
        cs.phase_forward(model)
        widths = cs.linear_attention_widths(model)
        del model
        torch.cuda.empty_cache()
        cs.phase_v1(widths)
        cs.train("flagship", cs.flagship_train_config(None),
                 {"folded_context": 6, "folded_project": 6}, check_sampler=True)
        cs.train("fa16", cs.flagship_train_config(cs.FA16),
                 {"flash_attention": 2, "folded_context": 4, "folded_project": 4}, profile=True)
    cs.phase_app(smi)
    cs.phase_adaptive(smi)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--after-phases", choices=["none", "app", "all"], default="none",
                   help="chip_smoke.py's phases run first: 9 and 10a, or all up to 10a")
    p.add_argument("--pairs", type=int, default=8)
    p.add_argument("--margin-gib", type=float, default=16.0)
    p.add_argument("--rounds", default="plain,modules,pressure,convs,k1",
                   help="comma-separated; a round with ':nofence' runs K1 without its "
                        "proxy fence")
    p.add_argument("--launches", type=int, default=4000, help="K1 launches a library (k1)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sde_repro: no CUDA device", file=sys.stderr)
        return 1
    cs = smoke_module()
    smi = cs.nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.load_all([la.SOURCE])
    start = time.perf_counter()
    if args.after_phases != "none":
        phases_before_sde(cs, smi, args.after_phases)
    cfg = unconditional_64()
    model, table = cs.release_model(cfg)
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "cudnn": torch.backends.cudnn.version(), "rounds": {}}
    for label in args.rounds.split(","):
        t0 = time.perf_counter()
        name, _, mode = label.partition(":")
        variant = (mock.patch.object(la, "_library", lambda lib=nofence_library(): lib)
                   if mode == "nofence" else contextlib.nullcontext())
        with variant:
            result = run_round(name, model, table, cfg, args)
        report["rounds"][label] = result
        print(f"[{time.perf_counter() - start:7.1f}s] sde_repro {label} "
              f"({time.perf_counter() - t0:.1f} s): {json.dumps(result)}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


@functools.lru_cache(maxsize=1)
def nofence_library():
    """The linear-attention library built without K1's proxy fence."""
    from flowtrain_stochastic_interpolation_torch.tools import ab_linear_attention, variants

    return variants.build_variants(la.SOURCE, {"no proxy fence": [(K1_FENCE, "")]},
                                   ab_linear_attention._bind)["no proxy fence"]


def k1_round(launches: int) -> dict:
    """Launches of K1 (b8 × 262,144 tokens) that return other bits than the first,
    through the built library and the variant without the fence, in turns."""
    from flowtrain_stochastic_interpolation_torch.tools import ab_linear_attention as ab

    libs = {"kernel": la._library(), "no proxy fence": nofence_library()}
    _, k, v, mem_k, mem_v = ab.operands(8, 262144, torch.device("cuda"))
    first = {name: ab.context_launch(lib, k, v, mem_k, mem_v) for name, lib in libs.items()}
    differ = dict.fromkeys(libs, 0)
    for turn in range(4):
        for name, lib in libs.items():
            for _ in range(launches // 4):
                ctx = ab.context_launch(lib, k, v, mem_k, mem_v)
                differ[name] += not torch.equal(ctx, first[name])
    return {"launches": launches, "differ": differ,
            "first_equal": torch.equal(first["kernel"], first["no proxy fence"])}


def run_round(name: str, model, table, cfg, args):
    if name == "k1":
        return k1_round(args.launches)
    if name == "convs":
        return conv_round(model, cfg, args.margin_gib)
    if name == "pressure":
        with pressure(args.margin_gib) as held:
            pairs = [sde_pair(model, table, cfg, True) for _ in range(args.pairs)]
        return {"buffer_gib": held / 2**30, "pairs": pairs}
    return [sde_pair(model, table, cfg, name == "modules", name == "kernels")
            for _ in range(args.pairs)]


if __name__ == "__main__":
    sys.exit(main())

"""Export a training checkpoint of the port to the release-weights format.

Port of the root ``tools/export_weights.py``. A checkpoint directory of the
port (``train/checkpoint.py``: the whole state, with the optimiser's moments)
is distilled into the JAX package's release directory (``weights.msgpack``
at about 2 bytes a parameter in bf16, ``config.json``, ``meta.json``), which
the JAX package's ``load_release_weights`` reads as it reads its own. The
params, the EMA shadow and the model's constants (a RandomFourier time
embedding's frozen features) are written as flax trees
(``models.persistence.params_to_jax``). A host-side reshuffle: it runs on the
CPU and needs no card.

    python -m flowtrain_stochastic_interpolation_torch.tools.export_weights \\
        --ckpt artifacts/torch/train_demo/ckpt --out my_release [--dtype float32]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from flowtrain_stochastic_interpolation_torch.models.persistence import (
    params_to_jax,
    save_release_weights,
)
from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state


def export(ckpt: str, out: str, dtype: str = "bfloat16", note: str = "") -> int:
    """Write the latest checkpoint of ``ckpt`` as a release directory ``out``;
    returns its size in bytes."""
    mgr = CheckpointManager(ckpt)
    config = mgr.load_config()
    if config is None:
        raise FileNotFoundError(f"{ckpt}/config.json missing")
    _, _, state = init_train_state(config, device="cpu")
    state = mgr.restore(state)
    print(f"restored step {state.step} from {ckpt}")
    buffers = state.model_buffers()
    save_release_weights(
        out,
        params=params_to_jax(state.params),
        ema_params=None if state.ema_params is None else params_to_jax(state.ema_params),
        model_constants=params_to_jax(buffers) if buffers else {},
        config_json=config.to_json(),
        step=state.step,
        dtype=dtype,
        note=note,
    )
    return sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", required=True, help="checkpoint dir of the port")
    p.add_argument("--out", required=True, help="release-weights output dir")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--note", default="")
    args = p.parse_args(argv)
    size = export(args.ckpt, args.out, args.dtype, args.note)
    print(f"wrote {args.out} ({size / 1e6:.1f} MB)")
    return size


if __name__ == "__main__":
    main()

"""The DDPM deployment sampler (``core/ddpm.py::inference_dynamic``) on the
way to the card, on the CPU in float32.

* what the deployed samplers keep on the host meets x only as 0-d tensors,
  the one kind of host tensor PyTorch lets meet a tensor on the card (checked
  on the meta device, which holds to the same rule);
* a DDPM acoustic model, shallow and not, exported with ``torch.export``,
  saved and loaded as a ``.pt2`` against eager ``forward_infer_dynamic``
  within 1e-6, and its graph lowered to ONNX through the interpreter within
  1e-4, at step counts and depths other than the traced example.

The parity of ``forward_infer_dynamic`` with the JAX package's is
``tests/test_torch_export.py``'s; the card's launches are
``tests/test_torch_cuda.py``'s.
"""

import numpy as np
import pytest
import torch

from diffsinger_tpu_torch.core import ddpm, reflow
from diffsinger_tpu_torch.core.schedule import DiffusionSchedule
from diffsinger_tpu_torch.deployment.exporters import AcousticProgram
from diffsinger_tpu_torch.deployment.onnx import EMITTED_OPS, lower_program, run_model
from diffsinger_tpu_torch.deployment.onnx.checker import check_model
from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
from tests.torch_parity import HP, MELS, VOCAB, acoustic_inputs

DDPM = {
    "ddpm-shallow": dict(diffusion_type="ddpm", K_step=400, K_step_infer=400, diff_speedup=10),
    "ddpm": dict(diffusion_type="ddpm", use_shallow_diffusion=False, diff_speedup=10),
}


@pytest.mark.parametrize("sampler", ["reflow", "reflow-shallow", "ddpm", "ddpm-shallow"])
def test_deployed_samplers_meet_the_device_only_with_0d_host_values(sampler):
    """Depth, steps, the counter and the schedule's numbers stay on the host
    and meet x, on the card, only as 0-d tensors: PyTorch lets nothing else
    of the host meet a tensor on another device. The meta device holds to
    the same rule, so x lives there; the loop's test runs on the host."""
    b = 2
    noise = torch.empty((b, 8, 4), device="meta")
    x_start = torch.empty((b, 8, 4), device="meta") if "shallow" in sampler else None
    calls = []

    def denoise(x, t):
        assert x.device == t.device and t.shape == (b,)
        calls.append(1)
        return x * 0.5

    for steps in (1, 3):
        if sampler.startswith("ddpm"):
            x = ddpm.inference_dynamic(denoise, DiffusionSchedule.create("linear", 1000), noise,
                                       depth=torch.tensor(0.3), steps=torch.tensor(steps),
                                       k_step=400 if x_start is not None else 1000,
                                       x_start=x_start)
        else:
            x = reflow.inference_dynamic(denoise, noise, depth=torch.tensor(0.6),
                                         steps=torch.tensor(steps), t_start_min=0.4,
                                         time_scale_factor=1000.0, x_end=x_start)
        assert x.device == noise.device and x.shape == noise.shape
    # shallow DDPM from 300 of 1000 steps: 1 call at speedup 300, 3 at 100;
    # without a source the speedup snaps to a divisor of 1000: 1000 (999 -> 0,
    # 1 call), then 250 for 1000 // 3 (999 -> 750, 4 calls)
    assert len(calls) == {"reflow": 1 + 3, "reflow-shallow": 1 + 3, "ddpm": 1 + 4,
                          "ddpm-shallow": 1 + 3}[sampler]


def seeded_model(hp: dict, seed: int) -> DiffSingerAcoustic:
    """A float32 model with every weight moved off its init, so that the step
    count and the depth move the sample."""
    torch.manual_seed(seed)
    model = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=MELS, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    state = {}
    for k, v in model.module.state_dict().items():
        if k.endswith("net.5.weight"):  # PReLU slopes stay in (0, 1)
            state[k] = 0.1 + 0.4 * torch.rand(v.shape, generator=g)
        else:
            scale = 0.3 if v.ndim == 1 else 0.02 + 0.5 * float(v.std())
            state[k] = v + scale * torch.randn(v.shape, generator=g)
    model.module.load_state_dict(state)
    model.module.requires_grad_(False)
    return model


@pytest.mark.parametrize("model", list(DDPM))
def test_ddpm_programs_equal_the_eager_model(model, tmp_path):
    port = seeded_model(dict(HP, **DDPM[model], use_energy_embed=False,
                             use_key_shift_embed=False), seed=8)
    inp = acoustic_inputs(seed=9, b=1, t_mel=40)
    noise = torch.from_numpy(np.random.default_rng(10).standard_normal((1, 40, MELS))
                             .astype(np.float32))
    base = (torch.from_numpy(inp["tokens"]), torch.from_numpy(inp["mel2ph"]),
            torch.from_numpy(inp["f0"]))
    with torch.no_grad():
        ep = torch.export.export(AcousticProgram(port, "acoustic", [], {}, None, None),
                                 (*base, torch.tensor(0.2), torch.tensor(2, dtype=torch.int32),
                                  noise))
    torch.export.save(ep, str(tmp_path / "acoustic.pt2"))
    program = torch.export.load(str(tmp_path / "acoustic.pt2")).module()
    data = lower_program(ep, name="acoustic", output_names=["mel"],
                         input_names=["tokens", "mel2ph", "f0", "depth", "steps",
                                      "noise"]).model_bytes()
    check_model(data, known_ops=EMITTED_OPS)
    outs = []
    for depth, steps in ((0.2, 3), (0.35, 5)):
        args = (torch.tensor(depth), torch.tensor(steps, dtype=torch.int32), noise)
        with torch.no_grad():
            want = port.forward_infer_dynamic(*base, depth=args[0], steps=args[1],
                                              noise=noise).diff_out.numpy()
            got = program(*base, *args).numpy()
        (onnx,) = run_model(data, {"tokens": inp["tokens"], "mel2ph": inp["mel2ph"],
                                   "f0": inp["f0"], "depth": np.float32(depth),
                                   "steps": np.int32(steps), "noise": noise.numpy()})
        assert np.abs(got - want).max() <= 1e-6
        assert np.abs(onnx - want).max() <= 1e-4
        outs.append(want)
    assert not np.allclose(outs[0], outs[1])

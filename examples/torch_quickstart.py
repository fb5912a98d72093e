"""Quickstart of the PyTorch + CUDA port: train a LUT-DNN with the
SparseLUT toolflow on the CUDA card (port of ``examples/quickstart.py``).

The three-stage pipeline of the paper (Fig. 6), minimally:
  1. learn the connectivity mask with the non-greedy Alg.-2 search;
  2. QAT-train the PolyLUT-Add model over that mask;
  3. synthesise truth tables and serve in pure-integer LUT mode, through
     the fused LUT kernel (``kernels/lut_gather/ops.lut_network_fused``).

    PYTHONPATH=src python examples/torch_quickstart.py
"""
import torch

from repro_torch.configs import paper_models as PM
from repro_torch.core import lut_synth as LS
from repro_torch.core import lutdnn as LD
from repro_torch.core.cost_model import model_cost
from repro_torch.data.loader import batch_iterator, train_test_split
from repro_torch.data.synthetic import make_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels.lut_gather import ops as lg_ops


def main(device=None):
    dev = resolve_device(device)
    data = train_test_split(make_dataset("jsc", n_samples=4000, seed=0))
    spec = PM.tiny("jsc", degree=2, fan_in=2, adder_width=2)
    print(f"model: {spec.name}  table entries: {spec.table_entries}  "
          f"device: {dev}")
    print(f"modeled FPGA cost: {model_cost(spec)}")

    # 1. connectivity search (SparseLUT Alg. 1 + 2)
    print("\n[1/3] connectivity search (non-greedy, dense-to-sparse)…")
    it = batch_iterator(data["train"], 256, seed=0, device=dev)
    masks, hist, _ = LD.search_connectivity(
        torch.Generator(device=dev).manual_seed(0), spec, it, n_steps=150,
        phase_frac=0.6, eps2=2e-3, device=dev)
    print(f"  search accuracy trace: "
          f"{[round(h['acc'], 3) for h in hist]}")
    conn = LD.masks_to_conn(masks, spec)

    # 2. QAT retraining with the learned mask
    print("[2/3] LUT-DNN QAT training with the learned mask…")
    init_state, step = LD.make_train_step(spec, lr=5e-3)
    state = init_state(torch.Generator(device=dev).manual_seed(1), dev)
    state["model"]["conn"] = conn
    it = batch_iterator(data["train"], 256, seed=1, device=dev)
    for _ in range(200):
        state, _ = step(state, next(it))
    test = {k: torch.from_numpy(v).to(dev) for k, v in data["test"].items()}
    acc, _ = LD.make_eval_step(spec)(state["model"], test)
    print(f"  test accuracy: {float(acc):.4f}")

    # 3. synthesis + LUT-mode serving through the fused LUT kernel
    print("[3/3] truth-table synthesis + LUT-mode serving…")
    tables = LS.synthesise(state["model"], spec)
    x = test["x"][:512]
    fq = spec.layer_specs()[0].in_quant
    out = lg_ops.lut_network_fused(tables, fq.to_code(fq.clip(x)))
    pred = torch.argmax(LS.OUTPUT_QUANT.from_code(out), -1)
    lut_acc = float((pred == test["y"][:512]).float().mean())
    with torch.no_grad():
        qat_pred = torch.argmax(
            LD.forward(state["model"], spec, x, train=False)[0], -1)
    agree = float((pred == qat_pred).float().mean())
    print(f"  LUT-mode accuracy: {lut_acc:.4f}  "
          f"(argmax agreement with QAT model: {agree:.1%})")
    return lut_acc, agree


if __name__ == "__main__":
    main()

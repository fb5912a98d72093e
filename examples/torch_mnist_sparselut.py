"""Full SparseLUT toolflow on the MNIST-like benchmark with the PyTorch
+ CUDA port (port of ``examples/mnist_sparselut.py``): random vs DeepR*
vs SparseLUT connectivity on a PolyLUT-Add model, with the centre-mass
heat-map statistic and modeled hardware cost, on the CUDA card unless
``--device`` names another device.

    PYTHONPATH=src python examples/torch_mnist_sparselut.py [--steps N]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import lutdnn as LD
from repro_torch.core.cost_model import model_cost
from repro_torch.core.lutdnn import ModelSpec
from repro_torch.data.loader import batch_iterator, train_test_split
from repro_torch.data.synthetic import make_dataset
from repro_torch.device import resolve_device


def centre_mass(mask_784xN: np.ndarray) -> float:
    img = mask_784xN.sum(1).reshape(28, 28)
    return float(img[7:21, 7:21].sum() / (img.sum() + 1e-12))


def train_with(spec, data, conn, steps, dev, seed=0):
    init_state, step = LD.make_train_step(spec, lr=5e-3)
    state = init_state(torch.Generator(device=dev).manual_seed(seed), dev)
    if conn is not None:
        state["model"]["conn"] = conn
    it = batch_iterator(data["train"], 256, seed=seed, device=dev)
    for _ in range(steps):
        state, _ = step(state, next(it))
    test = {k: torch.from_numpy(v).to(dev) for k, v in data["test"].items()}
    acc, _ = LD.make_eval_step(spec)(state["model"], test)
    return float(acc)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = train_test_split(make_dataset("mnist", n_samples=6000, seed=0))
    spec = ModelSpec(name="hdr-mini-add2", in_features=784,
                     widths=(128, 64, 10), bits=2, fan_in=3,
                     degree=1, adder_width=2)
    print(f"model {spec.name}: entries={spec.table_entries}  "
          f"cost={model_cost(spec)}  device={dev}")

    # random connectivity (3 seeds)
    rand = [train_with(spec, data, None, args.steps, dev, seed=s)
            for s in (0, 1, 2)]
    print(f"random connectivity acc: mean={np.mean(rand):.4f} "
          f"min={min(rand):.4f} max={max(rand):.4f}")

    # DeepR* search
    it = batch_iterator(data["train"], 256, seed=5, device=dev)
    md, _, _ = LD.search_connectivity(
        torch.Generator(device=dev).manual_seed(5), spec, it,
        n_steps=args.steps, mode="deepr", device=dev)
    acc_d = train_with(spec, data, LD.masks_to_conn(md, spec), args.steps,
                       dev)
    print(f"DeepR* connectivity acc: {acc_d:.4f}  "
          f"centre-mass={centre_mass(md[0].cpu().numpy()):.3f}")

    # SparseLUT search (non-greedy)
    it = batch_iterator(data["train"], 256, seed=6, device=dev)
    ms, _, _ = LD.search_connectivity(
        torch.Generator(device=dev).manual_seed(6), spec, it,
        n_steps=args.steps, phase_frac=0.6, eps2=2e-3, device=dev)
    acc_s = train_with(spec, data, LD.masks_to_conn(ms, spec), args.steps,
                       dev)
    print(f"SparseLUT connectivity acc: {acc_s:.4f}  "
          f"centre-mass={centre_mass(ms[0].cpu().numpy()):.3f}  "
          f"(chance centre-mass = 0.25)")
    print(f"\ngain over random: {acc_s - np.mean(rand):+.4f} "
          f"(paper Table VII reports +1.4-2.1% at full scale)")
    return {"random": rand, "deepr": acc_d, "sparselut": acc_s}


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Reference accuracy of the ``[train]`` phase of ``chip_smoke.py``.

Trains HDR-Add2 (``configs/paper_models.hdr_add2()``) with the JAX
package exactly as that phase trains it with the port: 250 steps of
``make_train_step`` at lr 5e-3 and batch 256 on
``make_dataset("mnist", 12000, seed=0)`` split by ``train_test_split``,
then ``make_eval_step`` on the test split.  One run per seed, which
seeds the initial model and the batch order.

The initial model is the port's: ``repro_torch.core.lutdnn.init_model``
on a CPU ``torch.Generator`` seeded with the seed (the draws the
``[train]`` phase makes, then carried into JAX), so the two packages
start from the same parameters and connectivity.  Across seeds the
test accuracy spreads by more than 0.1, so only runs from one start
compare.  ``--jax-init`` draws the start with ``jax.random`` instead
(the reference's own ``init_state``), for that spread.  ``--port``
also trains the port on the CPU from the same start.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python aref_hdr_add2.py --seeds 0 1

``--search`` runs the protocol of ``chip_smoke.py``'s ``[search]``
phase with the JAX package instead: a 4-member
``search_connectivity_population`` by ``jax.random`` (key 3, 100 steps
of batch 256 in batch order 3, ``phase_frac`` 0.6, ``eps2`` 2e-3, lr
0.15, the reference's paper-scale MNIST protocol), the best member by
``select_best_masks``, its masks through ``masks_to_conn``, then the
``[train]`` recipe from each of the port's starts with that
connectivity in place of the start's random one.  It prints each
start's searched and random accuracy and their means: the searched
mean is ``chip_smoke.A_REF_SEARCH``.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python aref_hdr_add2.py --search
"""
import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import paper_models as PM
from repro.core import lutdnn as LD
from repro.data.loader import batch_iterator, train_test_split
from repro.data.synthetic import make_dataset
from repro.optim.adamw import adamw


def port_init(seed: int):
    """The port's initial HDR-Add2 model from a CPU generator seeded
    ``seed``, as numpy leaves, and its checksum (``init_checksum``)."""
    import torch
    from repro_torch.configs import paper_models as TPM
    from repro_torch.core import lutdnn as TLD
    import chip_smoke

    model = TLD.init_model(torch.Generator().manual_seed(seed),
                           TPM.hdr_add2(), device="cpu")
    return TLD.model_to_numpy(model), chip_smoke.init_checksum(model)


SEARCH = dict(n_steps=100, n_seeds=4, phase_frac=0.6, eps2=2e-3, lr=0.15)
SEARCH_SEED = 3


def search_conn(data, batch: int):
    """The [search] protocol's population search by the JAX package ->
    (the best member's conn as numpy arrays, member scores, best)."""
    spec = PM.hdr_add2()
    it = batch_iterator(data["train"], batch, seed=SEARCH_SEED)
    masks, scores, _, _ = LD.search_connectivity_population(
        jax.random.key(SEARCH_SEED), spec, it, **SEARCH)
    best_masks, best = LD.select_best_masks(masks, scores)
    conn = [np.asarray(c) for c in LD.masks_to_conn(best_masks, spec)]
    return conn, [float(s) for s in np.asarray(scores)], best


def run(seed: int, steps: int, lr: float, batch: int, jax_init: bool,
        port: bool, conn=None) -> dict:
    data = train_test_split(make_dataset("mnist", 12000, seed=0))
    spec = PM.hdr_add2()
    init_state, step = LD.make_train_step(spec, lr=lr)
    out = {}
    if jax_init:
        state = init_state(jax.random.key(seed))
    else:
        tree, out["init_checksum"] = port_init(seed)
        if conn is not None:
            tree["conn"] = conn
        model = jax.tree.map(jnp.asarray, tree)
        state = {"model": model, "opt": adamw(lr)[0](model["layers"])}
    jstep = jax.jit(step)
    it = batch_iterator(data["train"], batch, seed=seed)
    for _ in range(steps):
        state, _ = jstep(state, next(it))
    acc, _ = jax.jit(LD.make_eval_step(spec))(state["model"], data["test"])
    out["jax"] = float(acc)
    if port and not jax_init:
        import torch
        from repro_torch.configs import paper_models as TPM
        from repro_torch.core import lutdnn as TLD
        from repro_torch.data.loader import batch_iterator as tbatches
        from repro_torch.data.loader import to_device
        from repro_torch.optim.adamw import adamw as tadamw

        tspec = TPM.hdr_add2()
        _, tstep = TLD.make_train_step(tspec, lr=lr)
        m = TLD.model_from_numpy(tree, tspec, device="cpu")
        st = {"model": m, "opt": tadamw(lr)[0](m["layers"])}
        tit = tbatches(data["train"], batch, seed=seed, device="cpu")
        for _ in range(steps):
            st, _ = tstep(st, next(tit))
        acc, _ = TLD.make_eval_step(tspec)(st["model"],
                                           to_device(data["test"], "cpu"))
        out["port_cpu"] = float(acc)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--jax-init", action="store_true")
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--search", action="store_true")
    args = ap.parse_args()
    if args.search:
        t0 = time.perf_counter()
        data = train_test_split(make_dataset("mnist", 12000, seed=0))
        conn, scores, best = search_conn(data, args.batch)
        print(f"search: member scores {scores}, best {best} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        arms = {"searched": {}, "random": {}}
        for s in args.seeds:
            for arm, c in (("searched", conn), ("random", None)):
                arms[arm][s] = run(s, args.steps, args.lr, args.batch,
                                   False, False, conn=c)["jax"]
                print(f"seed {s} {arm}: {arms[arm][s]:.7f}", flush=True)
        means = {a: float(np.mean(list(r.values()))) for a, r in
                 arms.items()}
        print(json.dumps({"search": SEARCH, "scores": scores, "best": best,
                          "runs": arms, "A_REF_SEARCH": means["searched"],
                          "random_mean": means["random"],
                          "searched_minus_random":
                              means["searched"] - means["random"]}))
        return
    runs = {}
    for s in args.seeds:
        t0 = time.perf_counter()
        runs[s] = run(s, args.steps, args.lr, args.batch, args.jax_init,
                      args.port)
        print(f"seed {s}: {runs[s]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    accs = [r["jax"] for r in runs.values()]
    print(json.dumps({"runs": runs, "jax_mean": float(np.mean(accs))}))


if __name__ == "__main__":
    main()

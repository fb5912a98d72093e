"""Port parity, data half: ``repro_torch.core.quant`` / ``layers`` /
``lutdnn`` / ``cost_model`` / ``configs.paper_models`` against the JAX
reference.  Quantizer codes are integers and must match exactly
(tolerance 0); ``from_code`` values are float32 and must match exactly
too, since both packages do one float32 multiply and one add."""
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import paper_models as jpm
from repro.core import cost_model as jcm
from repro.core import quant as jq
from repro_torch.configs import paper_models as tpm
from repro_torch.core import cost_model as tcm
from repro_torch.core import quant as tq

torch.set_num_threads(1)

# dyadic ranges put exact half steps on the grid (ties round to even);
# the paper's ranges exercise the non-dyadic steps
SPECS = [(1, 0.0, 1.0), (2, 0.0, 3.0), (3, -4.0, 3.0), (2, -1.0, 1.0),
         (2, 0.0, 1.0), (3, -1.0, 1.0), (5, 0.0, 1.0), (7, -1.0, 1.0),
         (16, -8.0, 8.0)]


def test_quant_codes_match_reference():
    rng = np.random.default_rng(0)
    for bits, low, high in SPECS:
        j, t = jq.QuantSpec(bits, low, high), tq.QuantSpec(bits, low, high)
        assert (t.levels, t.step) == (j.levels, j.step)
        k = np.arange(t.levels, dtype=np.float32)
        x = np.concatenate([
            rng.uniform(low - 0.5, high + 0.5, 2048),
            low + (k + 0.5) * np.float32(t.step),     # half steps
            low + k * np.float32(t.step),             # grid points
            [low, high, low - 1.0, high + 1.0]]).astype(np.float32)
        want = np.asarray(j.to_code(jnp.asarray(x)))
        got = t.to_code(torch.from_numpy(x)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        codes = np.arange(t.levels, dtype=np.int32)
        np.testing.assert_array_equal(
            t.from_code(torch.from_numpy(codes)).numpy(),
            np.asarray(j.from_code(jnp.asarray(codes))))
        np.testing.assert_array_equal(t.all_codes().numpy(),
                                      np.asarray(j.all_codes()))
        np.testing.assert_array_equal(
            t.clip(torch.from_numpy(x)).numpy(),
            np.asarray(j.clip(jnp.asarray(x))))
    for fn in ("input_quant", "act_quant"):
        assert getattr(tq, fn)(3) == tq.QuantSpec(
            **vars(getattr(jq, fn)(3)))
    assert tq.adder_quant(2, 2) == tq.QuantSpec(**vars(jq.adder_quant(2, 2)))


def test_paper_models_and_cost_model_match_reference():
    names = ["hdr", "hdr_add2", "hdr_5l", "jsc_xl", "jsc_xl_add2",
             "jsc_m_lite", "jsc_m_lite_add2", "jsc_2l", "cifar_hdr",
             "cifar_hdr_add2"]
    for name in names:
        j, t = getattr(jpm, name)(), getattr(tpm, name)()
        assert vars(t) == vars(j)
        assert t.table_entries == j.table_entries
        for ls_t, ls_j in zip(t.layer_specs(), j.layer_specs()):
            assert (ls_t.n_in, ls_t.n_out, ls_t.fan_in, ls_t.adder_width,
                    ls_t.is_output, ls_t.n_monomials,
                    vars(ls_t.sub_quant), vars(ls_t.in_quant),
                    vars(ls_t.out_quant)) == \
                (ls_j.n_in, ls_j.n_out, ls_j.fan_in, ls_j.adder_width,
                 ls_j.is_output, ls_j.n_monomials, vars(ls_j.sub_quant),
                 vars(ls_j.in_quant), vars(ls_j.out_quant))
        assert tcm.model_cost(t).row() == jcm.model_cost(j).row()
    deep = tpm.deeper(tpm.hdr_add2(), 2)
    assert deep.widths == jpm.deeper(jpm.hdr_add2(), 2).widths

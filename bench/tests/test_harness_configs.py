"""The configuration files against the port's paper models."""
import pytest

from conftest import config_file
from harness.spec import Benchmark
from repro_torch.configs import paper_models


def _specs_as_layers(spec):
    return [{"n_in": s.n_in, "n_out": s.n_out, "A": s.adder_width,
             "F": s.fan_in, "in_bits": s.in_quant.bits,
             "sub_bits": s.sub_quant.bits,
             "out_bits": 16 if s.is_output else s.out_quant.bits}
            for s in spec.layer_specs()]


@pytest.mark.parametrize("name, model", [
    ("hdr-add2", paper_models.hdr_add2),
    ("jsc-xl-add2", paper_models.jsc_xl_add2)])
def test_config_layers_are_the_paper_models(name, model):
    cfg = config_file(name)
    spec = model()
    assert cfg["layers"] == _specs_as_layers(spec)
    assert cfg["n_in"] == spec.in_features
    assert cfg["input_bits"] == cfg["layers"][0]["in_bits"]
    assert cfg["reduced"] == [] and cfg["assumed"]


def test_every_config_entry_names_its_file():
    bench = Benchmark()
    for c in bench.spec["configs"]:
        assert bench.config(c["name"])["name"] == c["name"]
        assert c["reduced"] == bench.config(c["name"])["reduced"]

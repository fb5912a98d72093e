"""SparseLUT core: the paper's contribution as composable PyTorch
modules (port of ``repro.core``; the same exported names)."""
from repro_torch.core.quant import QuantSpec, input_quant, act_quant
from repro_torch.core.masking import (ThetaLayer, init_theta_layer,
                                      random_mask, mask_to_indices,
                                      final_mask, effective_weight)
from repro_torch.core.sparse_train import SparsityConfig, sparse_control
from repro_torch.core.layers import LayerSpec, make_layer_specs
from repro_torch.core.lutdnn import (ModelSpec, init_model, forward,
                                     make_train_step, make_search_step,
                                     search_connectivity, masks_to_conn)
from repro_torch.core.lut_synth import synthesise, lut_forward
from repro_torch.core.cost_model import model_cost, HardwareReport

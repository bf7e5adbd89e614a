from .layers import (PSpec, apply_rope, materialize, mlp_apply, mlp_specs,
                     rmsnorm, rmsnorm_spec, stack_specs)
from .transformer import (forward_hidden, init_params, logits_fn, param_specs,
                          unembed_weight)

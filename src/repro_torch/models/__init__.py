from .layers import (PSpec, apply_rope, materialize, mlp_apply, mlp_specs,
                     rmsnorm, rmsnorm_spec, stack_specs)
from .transformer import (cache_specs, decode_step, forward_hidden, init_cache,
                          init_params, logits_fn, param_specs, unembed_weight)

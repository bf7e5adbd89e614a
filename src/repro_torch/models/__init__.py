from .layers import (PSpec, abstract, apply_rope, axes_tree, materialize, mlp_apply,
                     mlp_specs, rmsnorm, rmsnorm_spec, stack_specs)
from .transformer import (abstract_params, cache_axes, cache_specs, decode_step,
                          forward_hidden, init_cache, init_params, logits_fn, param_axes,
                          param_specs, unembed_weight)

from .base import (SHAPES, LayerSpec, MLAConfig, ModelConfig, MoEConfig,
                   ShapeConfig, SSMConfig, reduced)
from .registry import (ARCH_IDS, SUB_QUADRATIC, all_cells, cell_status,
                       get_config, get_shape, smoke_config)

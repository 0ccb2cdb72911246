"""The port's model zoo.

- transformer: TransformerLM (BERT-large/GPT configs, MoE option)
- moe: MoeMlp (top-k routed experts, dense dispatch)
- vision: ResNet50/101/152, VGG16, DenseNet121, InceptionV3
- rnn: LSTMLM (lm1b role)
- ncf: NCF recommender (sparse embeddings role)
"""
from autodist_tpu_torch.models.core import (Dense, Embedding,  # noqa: F401
                                            LayerNorm, Mlp, Module,
                                            ParamDef)
from autodist_tpu_torch.models.moe import MoeMlp  # noqa: F401
from autodist_tpu_torch.models.ncf import NCF  # noqa: F401
from autodist_tpu_torch.models.rnn import LSTMLM  # noqa: F401
from autodist_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig, TransformerLM)
from autodist_tpu_torch.models.vision import (DenseNet,  # noqa: F401
                                              InceptionV3, ResNet, VGG)

"""The port's model zoo.

- transformer: TransformerLM (BERT-large/GPT configs)
- vision: ResNet50/101/152, VGG16, DenseNet121, InceptionV3
- rnn: LSTMLM (lm1b role)
- ncf: NCF recommender (sparse embeddings role)
"""
from autodist_tpu_torch.models.ncf import NCF  # noqa: F401
from autodist_tpu_torch.models.rnn import LSTMLM  # noqa: F401

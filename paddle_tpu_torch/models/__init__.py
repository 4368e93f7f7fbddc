"""Models (port of ``paddle_tpu/models``): the Llama flagship (training,
serving and generation, with the HF importer), Transformer-base, the
conv nets (ResNet, VGG, SE-ResNeXt, the MNIST CNN), the MNIST MLP and
fit-a-line, the CTR models (DeepFM, wide&deep), word2vec, the
recommender and the stacked dynamic LSTM, and the zoo's entries for
them. The other model modules wait for their ROADMAP.md items and are
refused by name."""
from ..waiting import REST, module_getattr
from . import ctr             # noqa: F401
from . import fit_a_line      # noqa: F401
from . import llama           # noqa: F401
from . import llama_import    # noqa: F401
from . import mnist           # noqa: F401
from . import resnet          # noqa: F401
from . import recommender     # noqa: F401
from . import se_resnext      # noqa: F401
from . import stacked_dynamic_lstm  # noqa: F401
from . import transformer     # noqa: F401
from . import vgg             # noqa: F401
from . import word2vec        # noqa: F401
from . import zoo             # noqa: F401

WAITING = dict.fromkeys(("faster_rcnn", "label_semantic_roles",
                         "machine_translation", "ocr_recognition"), REST)
__getattr__ = module_getattr(__name__, WAITING)

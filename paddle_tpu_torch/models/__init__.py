"""Models (port of ``paddle_tpu/models``): the Llama flagship (training,
serving and generation, with the HF importer), Transformer-base, the
conv nets (ResNet, VGG, SE-ResNeXt, the MNIST CNN), the MNIST MLP and
fit-a-line, the CTR models (DeepFM, wide&deep), word2vec, the
recommender and the stacked dynamic LSTM, seq2seq machine translation,
semantic role labelling and CRNN-CTC OCR, and the zoo's entries for
them. ``faster_rcnn`` waits for its ROADMAP.md item and is refused by
name."""
from ..waiting import REST, module_getattr
from . import ctr             # noqa: F401
from . import fit_a_line      # noqa: F401
from . import llama           # noqa: F401
from . import label_semantic_roles  # noqa: F401
from . import llama_import    # noqa: F401
from . import machine_translation  # noqa: F401
from . import mnist           # noqa: F401
from . import ocr_recognition  # noqa: F401
from . import resnet          # noqa: F401
from . import recommender     # noqa: F401
from . import se_resnext      # noqa: F401
from . import stacked_dynamic_lstm  # noqa: F401
from . import transformer     # noqa: F401
from . import vgg             # noqa: F401
from . import word2vec        # noqa: F401
from . import zoo             # noqa: F401

WAITING = {"faster_rcnn": REST}
__getattr__ = module_getattr(__name__, WAITING)

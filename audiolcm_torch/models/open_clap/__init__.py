"""The LAION open_clap tree (`audiolcm_tpu/models/open_clap/`): the CLAP
model (audio and text towers, joint projections, logit scales), the HTSAT
Swin audio transformer, the PANN CNNs, attentional feature fusion, the
named-config factory with its checkpoint loader, the CLIP BPE tokenizer and
the two LAION text conditioners of the config registry. Reference
`ldm/modules/encoders/open_clap/`; its state-dict keys are kept, so a
reference checkpoint loads directly (`factory.load_checkpoint`).
"""

from audiolcm_torch.models.open_clap.embedders import (
    FrozenLAIONCLAPEmbedder,
    FrozenLAIONCLAPSetenceEmbedder,
)
from audiolcm_torch.models.open_clap.factory import (
    MODEL_CONFIGS,
    build_config,
    create_model,
    list_models,
)
from audiolcm_torch.models.open_clap.fusion import AFF, daf, iAFF
from audiolcm_torch.models.open_clap.htsat import HTSAT, HTSATConfig, htsat_preset
from audiolcm_torch.models.open_clap.model import MLPLayers, OpenClap, OpenClapConfig
from audiolcm_torch.models.open_clap.pann import PannAudioBranch, PannConfig
from audiolcm_torch.models.open_clap.text_towers import (
    BartConfig,
    BartEncoder,
    ClipTextTransformer,
    RobertaConfig,
    RobertaEncoder,
)
from audiolcm_torch.models.open_clap.tokenizer import ClipBpeTokenizer, tokenize

__all__ = [
    "AFF", "daf", "iAFF", "HTSAT", "HTSATConfig", "htsat_preset", "PannAudioBranch",
    "PannConfig", "ClipTextTransformer", "RobertaConfig", "RobertaEncoder", "BartConfig",
    "BartEncoder", "MLPLayers", "OpenClap", "OpenClapConfig", "MODEL_CONFIGS", "build_config",
    "create_model", "list_models", "ClipBpeTokenizer", "tokenize", "FrozenLAIONCLAPEmbedder",
    "FrozenLAIONCLAPSetenceEmbedder",
]

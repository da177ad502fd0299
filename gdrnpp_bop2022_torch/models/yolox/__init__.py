from .darknet import CSPDarknet
from .head import YOLOXHead, decode_outputs, flatten_outputs
from .pafpn import YOLOPAFPN
from .yolox import (YOLOX, build_yolox, make_inference, make_tta_inference,
                    postprocess_nms, tta_inference)

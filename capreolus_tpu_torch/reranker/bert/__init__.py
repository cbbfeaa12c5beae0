from capreolus_tpu_torch.reranker.bert.encoder import (
    BertConfig,
    BertEncoder,
    convert_hf_weights,
    get_bert_config,
    load_pretrained_encoder,
)

__all__ = ["BertConfig", "BertEncoder", "convert_hf_weights", "get_bert_config", "load_pretrained_encoder"]

from capreolus_tpu_torch.reranker.bert.encoder import (
    BertConfig,
    BertEncoder,
    convert_hf_weights,
    get_bert_config,
    load_pretrained_encoder,
    load_pretrained_nsp_head,
    nsp_logits_to_relevance_head,
    read_pretrained,
)

__all__ = ["BertConfig", "BertEncoder", "convert_hf_weights", "get_bert_config", "load_pretrained_encoder",
           "load_pretrained_nsp_head", "nsp_logits_to_relevance_head", "read_pretrained"]

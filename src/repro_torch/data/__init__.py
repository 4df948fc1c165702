from repro_torch.data.synthetic import SyntheticLM, node_batch_iterator

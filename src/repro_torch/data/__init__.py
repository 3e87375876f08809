from repro_torch.data.synthetic import MarkovLM, TopicRetrievalTask, sample_lengths  # noqa: F401

"""Tree arithmetic over nested dicts and NamedTuples of tensors, and small
logging and timing helpers."""

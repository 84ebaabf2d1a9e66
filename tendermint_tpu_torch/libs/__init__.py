"""Host helpers the types need."""

"""Data-side modules: vocabulary encoder and image transforms."""

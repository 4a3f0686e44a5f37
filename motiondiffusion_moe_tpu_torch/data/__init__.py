"""Motion feature normalization."""

"""Priority inference and content analysis of submitted messages."""

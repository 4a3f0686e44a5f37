"""Motion feature decoding (features -> joints)."""

"""Operations and bytes of the networks, from the configuration's shapes."""

"""Fixture config class: three fields + a derived property."""


class Cfg:
    dim: int = 8
    nprobe: int = 4
    extra: int = 0      # classified nowhere -> SPF105 (at the stamp site)

    @property
    def doubled(self) -> int:
        # property reads expand to their underlying fields: `cfg.doubled`
        # on the replay path must NOT fire SPF104 (dim is stamped)
        return self.dim * 2

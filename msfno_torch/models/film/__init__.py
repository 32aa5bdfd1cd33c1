from msfno_torch.models.film.wrapper import FilmWrapper  # noqa: F401
from msfno_torch.models.film.gcn import GCNFilmGenerator  # noqa: F401
from msfno_torch.models.film.vit import ViTFilmGenerator  # noqa: F401
from msfno_torch.models.film.mae import ContextCast  # noqa: F401
